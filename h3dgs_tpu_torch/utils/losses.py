"""Photometric losses: L1 and windowed SSIM (counterpart of
``h3dgs_tpu/utils/losses.py``).

SSIM uses the standard 11x11 Gaussian window with sigma=1.5, C1=0.01^2,
C2=0.03^2 and SAME zero padding. The separable blur is written as
float32 shifted adds, never a convolution: PyTorch runs float32
convolutions through cuDNN in TF32 by default, and the SSIM variance terms
(blur(x^2) - mu^2) cancel catastrophically at reduced precision on dark or
low-variance images (the reference's own note, l.41-50).

Images are ``[3, H, W]`` float32.
"""
from __future__ import annotations

import functools
import math
import os

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float):
    xs = [math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
          for x in range(window_size)]
    total = sum(xs)
    return tuple(x / total for x in xs)


def _blur(img: torch.Tensor, window) -> torch.Tensor:
    """Separable Gaussian blur with SAME (zero) padding. img: [C, H, W];
    ``window``: the taps as a float32 tensor (or floats). Rows (H) first,
    then columns (W), each as a sum of shifted, weighted copies."""
    k = len(window)
    r = k // 2
    _, h, w = img.shape

    def along(x, axis, size):
        pad = (0, 0, r, r) if axis == 1 else (r, r, 0, 0)
        xp = F.pad(x, pad)
        out = torch.zeros_like(x)
        for i in range(k):
            sl = xp[:, i:i + size] if axis == 1 else xp[:, :, i:i + size]
            out = out + window[i] * sl
        return out

    return along(along(img, 1, h), 2, w)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a [3, H, W] image pair."""
    window = torch.tensor(_gaussian_window(window_size, sigma),
                          dtype=img1.dtype, device=img1.device)
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2

    mu1 = _blur(img1, window)
    mu2 = _blur(img2, window)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window) - mu2_sq
    sigma12 = _blur(img1 * img2, window) - mu1_mu2

    ssim_map = (((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2))
                / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    return torch.mean(ssim_map)


# Same gate as the reference (h3dgs_tpu/utils/losses.py:119): the fused
# kernel stays off by default until a training run with it on has stayed
# finite; H3DGS_FUSED_SSIM=1 turns it on.
_FUSED_SSIM_VERIFIED = False


def fused_ssim_supported(pred: torch.Tensor) -> bool:
    """Shape/dtype/device gate for the fused SSIM kernel (K3): a CUDA
    float32 [3, H, W] tensor with H, W >= 11."""
    return (pred.dim() == 3 and pred.shape[0] == 3
            and pred.shape[1] >= 11 and pred.shape[2] >= 11
            and pred.dtype == torch.float32 and pred.is_cuda)


def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     lambda_dssim: float = 0.2,
                     fused: bool = None) -> torch.Tensor:
    """(1-l)*L1 + l*(1-SSIM), the reference's photo loss.

    ``fused``: use the single-pass fused loss (``ops/ssim.py``, kernel K3 on
    the card). None = auto: off unless ``H3DGS_FUSED_SSIM=1`` (or the
    module gate) asks for it and the tensor qualifies. The fused path
    differentiates ``pred`` only; pass ``fused=False`` where the target
    needs a gradient too."""
    if fused is None:
        env = os.environ.get("H3DGS_FUSED_SSIM")
        want = (env == "1") if env is not None else _FUSED_SSIM_VERIFIED
        fused = want and fused_ssim_supported(pred)
    if fused:
        from ..ops.ssim import fused_photometric_loss
        return fused_photometric_loss(pred, target, lambda_dssim)
    return ((1.0 - lambda_dssim) * l1_loss(pred, target)
            + lambda_dssim * (1.0 - ssim(pred, target)))
