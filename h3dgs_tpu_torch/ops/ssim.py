"""Fused photometric loss (K3): the CUDA kernel's wrapper and its plain
version.

Counterpart of ``h3dgs_tpu/ops/pallas_ssim.py``: (1-l)*mean|x-y| +
l*(1 - mean SSIM) over a [3, H, W] prediction x and target y, and its
gradient with respect to x, in one call. ``fused_photometric_loss`` is a
``torch.autograd.Function`` that differentiates ``pred`` only and returns
``None`` for ``target`` (``pallas_ssim.py:253-289``). CUDA tensors launch
``csrc/ssim.cu``; CPU tensors run ``fused_photometric_plain``, the same
loss and analytic gradient in plain torch (the formulas of
``pallas_ssim.py:13-30``, with the b2 clamp at c2/2), blurring with the
shifted adds of ``utils/losses.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.losses import _blur, _gaussian_window
from . import kernels

C1 = 0.01 ** 2
C2 = 0.03 ** 2
WIN = 11


def _window():
    """The 11 taps, sigma 1.5 (``pallas_ssim.py:_window``)."""
    return _gaussian_window(WIN, 1.5)


def fused_photometric_plain(pred: torch.Tensor, target: torch.Tensor,
                            lambda_dssim: float = 0.2):
    """(loss [], d loss / d pred [3,H,W]) in plain torch, in float32
    (float64 inputs stay float64, a reference for the rounding)."""
    lam = float(lambda_dssim)
    dt = torch.float64 if pred.dtype == torch.float64 else torch.float32
    x = pred.to(dt)
    y = target.to(dt)
    _, h, w = x.shape
    win = torch.tensor(_window(), dtype=dt, device=x.device)
    u = _blur(x, win)
    v = _blur(y, win)
    p2 = _blur(x * x, win)
    q2 = _blur(y * y, win)
    r2 = _blur(x * y, win)
    a1 = 2.0 * u * v + C1
    a2 = 2.0 * (r2 - u * v) + C2
    b1 = u * u + v * v + C1
    b2 = torch.clamp_min((p2 - u * u) + (q2 - v * v) + C2, 0.5 * C2)
    inv_b1 = 1.0 / b1
    inv_b2 = 1.0 / b2
    inv_d = inv_b1 * inv_b2
    smap = a1 * a2 * inv_d
    n = 3.0 * h * w
    diff = x - y
    # The two means are summed in float64, as the kernel sums its block
    # partials, so the loss does not carry float32 summation error.
    loss = ((1.0 - lam) * torch.mean(torch.abs(diff), dtype=torch.float64)
            + lam * (1.0 - torch.mean(smap, dtype=torch.float64))).to(dt)
    scale = -lam / n
    c_u = scale * (2.0 * v * (a2 - a1) * inv_d
                   - 2.0 * u * smap * (inv_b1 - inv_b2))
    c_p = scale * (-smap * inv_b2)
    c_r = scale * (2.0 * a1 * inv_d)
    grad = (_blur(c_u, win) + 2.0 * x * _blur(c_p, win)
            + y * _blur(c_r, win) + ((1.0 - lam) / n) * torch.sign(diff))
    return loss, grad


def _check(pred: torch.Tensor, target: torch.Tensor):
    for name, t in (("pred", pred), ("target", target)):
        if t.device.type != "cuda":
            raise ValueError(f"ssim kernel needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[0] != 3:
            raise ValueError(f"{name}: want float32 [3, H, W], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if pred.shape != target.shape or pred.device != target.device:
        raise ValueError(f"target {tuple(target.shape)} on {target.device} "
                         f"does not match pred {tuple(pred.shape)} on "
                         f"{pred.device}")
    if pred.shape[1] < WIN or pred.shape[2] < WIN:
        raise ValueError(f"ssim kernel needs H, W >= {WIN}, got "
                         f"{tuple(pred.shape)}")


def _launch_ssim(pred: torch.Tensor, target: torch.Tensor, lam: float):
    lib = kernels.load("ssim")
    fn = lib.ssim_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_void_p] * 8)
    n_blocks = lib.ssim_num_blocks
    n_blocks.restype = ctypes.c_int
    n_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    _, h, w = pred.shape
    dev = pred.device
    coef = torch.empty((3, 3, h, w), dtype=torch.float32, device=dev)
    partial = torch.empty((2 * n_blocks(h, w),), dtype=torch.float32,
                          device=dev)
    grad = torch.empty_like(pred)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    window = (ctypes.c_float * WIN)(*_window())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(pred.data_ptr(), target.data_ptr(), h, w, lam,
                    ctypes.addressof(window), coef[0].data_ptr(),
                    coef[1].data_ptr(), coef[2].data_ptr(),
                    partial.data_ptr(), grad.data_ptr(), loss.data_ptr(),
                    stream)
    kernels.check("ssim", status)
    kernels.LAUNCHES["ssim"] += 1
    return loss[0], grad


def fused_photometric_forward(pred: torch.Tensor, target: torch.Tensor,
                              lambda_dssim: float = 0.2):
    """(loss, grad) of the fused loss: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if pred.device.type == "cpu" and target.device.type == "cpu":
        return fused_photometric_plain(pred, target, lambda_dssim)
    _check(pred, target)
    return _launch_ssim(pred, target, float(lambda_dssim))


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, lam):
        loss, grad = fused_photometric_forward(pred.detach(),
                                               target.detach(), lam)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None, None


def fused_photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                           lambda_dssim: float = 0.2) -> torch.Tensor:
    """Drop-in ``photometric_loss`` with one fused forward + gradient pass.
    Differentiable with respect to ``pred`` only."""
    return _FusedLoss.apply(pred.contiguous(), target.contiguous(),
                            float(lambda_dssim))
