"""Convert LPIPS(vgg) weights to the .npz that ``eval/metrics.py`` loads
(the same file as ``h3dgs_tpu/eval/convert_lpips.py`` writes).

  python -m h3dgs_tpu_torch.eval.convert_lpips \
      --vgg16 vgg16-397923af.pth --lin vgg.pth --out lpips_vgg.npz

Reads two PyTorch state dicts from local files (``torch.load`` with
``weights_only=True``) and downloads nothing: torchvision's ``vgg16``
ImageNet checkpoint (its ``features.N.weight`` / ``.bias`` convolutions)
and the lpips package's ``weights/v0.1/vgg.pth`` linear heads
(``linN.model.1.weight``). Neither package is imported. Layout:
``conv{0..12}.weight`` / ``.bias`` (OIHW), ``lin{0..4}.weight``
([1, C, 1, 1], non-negative) and ``source_tag``. The tag is
``LPIPS_SOURCE_TAG`` only when the VGG16 file's sha256 starts with the
prefix torchvision names its checkpoint by; otherwise it records the
file's own prefix, and the loader warns that the weights are not the
standard ones.
"""
from __future__ import annotations

import argparse
import hashlib
import re

import numpy as np

_CONV_KEY = re.compile(r"^features\.(\d+)\.weight$")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def convert_state_dicts(vgg: dict, lin: dict, source_tag: str) -> dict:
    """The .npz arrays from the two state dicts (tensors or arrays)."""
    from .metrics import validate_weights_layout

    def arr(t):
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                          else t, np.float32)

    layers = sorted(int(m.group(1)) for m in map(_CONV_KEY.match, vgg) if m)
    arrays = {}
    for li, n in enumerate(layers):
        arrays[f"conv{li}.weight"] = arr(vgg[f"features.{n}.weight"])
        arrays[f"conv{li}.bias"] = arr(vgg[f"features.{n}.bias"])
    for i in range(5):
        arrays[f"lin{i}.weight"] = arr(lin[f"lin{i}.model.1.weight"])
    validate_weights_layout(arrays)
    arrays["source_tag"] = np.asarray(source_tag)
    return arrays


def convert(vgg_path: str, lin_path: str, out_path: str) -> str:
    import torch

    from .metrics import LPIPS_SOURCE_TAG

    prefix = LPIPS_SOURCE_TAG.split("-")[-1]
    digest = _sha256(vgg_path)
    tag = (LPIPS_SOURCE_TAG if digest.startswith(prefix)
           else f"vgg16-{digest[:len(prefix)]}")
    if tag != LPIPS_SOURCE_TAG:
        print(f"WARNING: {vgg_path} has sha256 {digest[:16]}..., not the "
              f"{LPIPS_SOURCE_TAG} checkpoint; tagging it {tag}")
    arrays = convert_state_dicts(
        torch.load(vgg_path, map_location="cpu", weights_only=True),
        torch.load(lin_path, map_location="cpu", weights_only=True), tag)
    np.savez(out_path, **arrays)
    print(f"LPIPS weights -> {out_path} (source {tag})")
    return tag


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vgg16", required=True,
                   help="torchvision vgg16 state dict (.pth)")
    p.add_argument("--lin", required=True,
                   help="lpips vgg.pth linear heads (state dict)")
    p.add_argument("--out", default="lpips_vgg.npz")
    a = p.parse_args(argv)
    convert(a.vgg16, a.lin, a.out)


if __name__ == "__main__":
    main()
