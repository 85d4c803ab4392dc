"""Evaluation metrics: PSNR / SSIM / LPIPS (counterpart of
``h3dgs_tpu/eval/metrics.py``).

PSNR and SSIM are the port's losses (``utils/losses.py``). LPIPS is the
reference's lpipsPyTorch usage: VGG16 features and linear heads, built as
a ``torch.nn.Module`` from an ``.npz`` of pretrained weights. This
repository holds no such file and nothing here downloads one: without
weights ``lpips`` returns None and the eval reports ``LPIPS_UNAVAILABLE``.
Convert weights on a machine that has the two checkpoints with
``python -m h3dgs_tpu_torch.eval.convert_lpips``; the file is looked for
at ``$H3DGS_LPIPS_WEIGHTS``, then ``weights/lpips_vgg.npz`` in the
repository, then ``~/.cache/h3dgs/lpips_vgg.npz``.

The convolutions run in full float32: cuDNN would run them in TF32 by
default on the card (about three decimal digits), where the reference pins
``precision=HIGHEST``. The switch is scoped to the LPIPS forward.
"""
from __future__ import annotations

import functools
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.losses import psnr, ssim  # noqa: F401  (re-exported)
from ..utils.runtime import as_tensor, resolve_device

LPIPS_WEIGHTS_ENV = "H3DGS_LPIPS_WEIGHTS"

# Sentinel written into eval JSONs when no weights artifact exists (the
# reference always reports the PSNR/SSIM/LPIPS triple; a bare ``null``
# would not say why the third metric is absent).
LPIPS_UNAVAILABLE = "unavailable(no-weights)"

# torchvision's checkpoint vgg16-397923af.pth is named by the sha256 prefix
# torchvision verifies on download. convert_lpips embeds this tag in the
# .npz; the loader warns when a weights file lacks it (random / test
# weights), so a wrong artifact cannot pass for the real metric.
LPIPS_SOURCE_TAG = "vgg16-397923af"

# VGG16 conv layout per block (out-channels); LPIPS reads each block's
# last ReLU.
_VGG_CFG = ((64, 64), (128, 128), (256, 256, 256),
            (512, 512, 512), (512, 512, 512))
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


_WARNED = [False]


def _default_weight_paths():
    """No-setup locations: repo-local weights/ and the user cache."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    yield os.path.join(here, "weights", "lpips_vgg.npz")
    yield os.path.expanduser("~/.cache/h3dgs/lpips_vgg.npz")


def _find_weights(path: Optional[str]) -> Optional[str]:
    cand = path or os.environ.get(LPIPS_WEIGHTS_ENV, "")
    if cand and os.path.exists(cand):
        return cand
    for p in _default_weight_paths():
        if os.path.exists(p):
            return p
    if not _WARNED[0]:  # loud, once: never silently degrade the eval
        _WARNED[0] = True
        print("[eval] LPIPS unavailable: no weights at "
              f"$({LPIPS_WEIGHTS_ENV}), weights/lpips_vgg.npz or "
              "~/.cache/h3dgs/lpips_vgg.npz — reporting PSNR/SSIM only. "
              "Convert once with python -m h3dgs_tpu_torch.eval."
              "convert_lpips from the torchvision and lpips checkpoints.",
              file=sys.stderr, flush=True)
    return None


def validate_weights_layout(z) -> None:
    """Structural checksum of an LPIPS .npz: 13 VGG16 convs with the
    exact channel progression, 3x3 kernels, and 5 non-negative linear
    heads over the block-final channels. Raises ValueError on any
    mismatch: a malformed artifact must fail the eval loudly, not produce
    a plausible-looking wrong number."""
    cin, li = 3, 0
    for block in _VGG_CFG:
        for cout in block:
            k = f"conv{li}.weight"
            if k not in z:
                raise ValueError(f"LPIPS weights missing {k}")
            if tuple(z[k].shape) != (cout, cin, 3, 3):
                raise ValueError(
                    f"LPIPS {k} shape {tuple(z[k].shape)} != "
                    f"{(cout, cin, 3, 3)}")
            if tuple(z[f"conv{li}.bias"].shape) != (cout,):
                raise ValueError(f"LPIPS conv{li}.bias shape mismatch")
            cin = cout
            li += 1
    for i, block in enumerate(_VGG_CFG):
        k = f"lin{i}.weight"
        if k not in z:
            raise ValueError(f"LPIPS weights missing {k}")
        if tuple(z[k].shape) != (1, block[-1], 1, 1):
            raise ValueError(
                f"LPIPS {k} shape {tuple(z[k].shape)} != "
                f"{(1, block[-1], 1, 1)}")
        if np.any(np.asarray(z[k]) < 0):
            raise ValueError(f"LPIPS {k} has negative entries (the "
                             "heads are non-negative by construction)")


class LPIPSNet(torch.nn.Module):
    """VGG16 features (13 convs with padding 1 and ReLU, 2x2 max-pool after
    blocks 0-3) and the five linear heads of LPIPS(vgg), from the arrays
    of an ``.npz`` that ``validate_weights_layout`` accepts."""

    def __init__(self, arrays):
        super().__init__()
        validate_weights_layout(arrays)
        n_convs = sum(len(b) for b in _VGG_CFG)
        for li in range(n_convs):
            for part in ("weight", "bias"):
                self.register_buffer(f"conv{li}_{part}", torch.as_tensor(
                    np.asarray(arrays[f"conv{li}.{part}"], np.float32)))
        for i in range(len(_VGG_CFG)):
            self.register_buffer(f"lin{i}", torch.as_tensor(
                np.asarray(arrays[f"lin{i}.weight"], np.float32)))
        self.register_buffer("shift", torch.as_tensor(_SHIFT)[:, None, None])
        self.register_buffer("scale", torch.as_tensor(_SCALE)[:, None, None])

    def features(self, x: torch.Tensor):
        """x: [N, 3, H, W] in [-1, 1]. Returns the five block outputs."""
        x = (x - self.shift) / self.scale
        feats = []
        li = 0
        for b, block in enumerate(_VGG_CFG):
            for _ in block:
                x = F.relu(F.conv2d(x, getattr(self, f"conv{li}_weight"),
                                    getattr(self, f"conv{li}_bias"),
                                    padding=1))
                li += 1
            feats.append(x)
            if b < len(_VGG_CFG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """LPIPS distance of two [3, H, W] images in [0, 1] (a scalar)."""
        x = torch.stack([img1, img2]).to(self.shift.dtype) * 2.0 - 1.0
        # cuDNN convolutions in full float32, not TF32, for this forward
        # only; the previous settings come back on exit.
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            feats = self.features(x)
        return self.distance(feats)

    def distance(self, feats) -> torch.Tensor:
        """The heads' distance between the two images of ``features``'
        output: channel-normalised, squared, head-weighted, averaged."""
        total = torch.zeros((), dtype=feats[0].dtype, device=feats[0].device)
        for i, f in enumerate(feats):
            fn = f / torch.sqrt(torch.sum(f ** 2, 1, keepdim=True) + 1e-10)
            d = (fn[0] - fn[1]) ** 2
            w = getattr(self, f"lin{i}")[0]                    # [C, 1, 1]
            total = total + torch.mean(torch.sum(d * w, dim=0))
        return total


@functools.lru_cache(maxsize=4)
def _load_weights(path: str, device: str) -> LPIPSNet:
    """The LPIPS network of ``path`` on ``device``, built once per pair."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    tag = str(arrays["source_tag"]) if "source_tag" in arrays else ""
    if LPIPS_SOURCE_TAG not in tag:
        print(f"[eval] WARNING: LPIPS weights at {path} carry no "
              f"'{LPIPS_SOURCE_TAG}' source tag — treat reported LPIPS "
              "as non-standard (test/random weights?)", file=sys.stderr,
              flush=True)
    return LPIPSNet(arrays).to(device).eval()


def lpips(img1, img2, weights_path: Optional[str] = None,
          device=None) -> Optional[float]:
    """LPIPS(vgg) distance for [3, H, W] images in [0, 1]; None if no
    weights are found. Runs on ``device``: the card unless the caller
    passes ``device="cpu"`` (raises when CUDA is missing and no device was
    asked for)."""
    path = _find_weights(weights_path)
    if path is None:
        return None
    dev = resolve_device(device)
    net = _load_weights(path, str(dev))
    with torch.no_grad():
        return float(net(as_tensor(img1, dev, torch.float32),
                         as_tensor(img2, dev, torch.float32)))
