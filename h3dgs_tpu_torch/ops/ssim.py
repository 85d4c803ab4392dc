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

The kernel is one launch: a block walks down a strip of one channel a row
a step, with the column blurs as sliding windows in registers.
``plan_strips`` sizes its grid and ``fused_photometric_walk`` is that
walk step for step in torch (the ring phases, the row and column rims,
the zero padding), so the CPU tests reach the kernel's index logic.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.losses import _blur, _gaussian_window
from . import kernels

C1 = 0.01 ** 2
C2 = 0.03 ** 2
WIN = 11
RAD = WIN // 2
HALO = 2 * RAD
# Rows a block owns at least: below this the 21 rim rows a block walks
# beside its own outweigh what more blocks would gain.
MIN_ROWS_PER_BLOCK = 32


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


def plan_strips(h: int, w: int, tile_w: int, slots: int):
    """(strips across, rows per block, blocks down) of the kernel's grid
    for an h x w image: ``tile_w`` output columns per strip, and as many
    blocks down the image as fit one wave of ``slots`` resident blocks
    over the three channels, each owning at least MIN_ROWS_PER_BLOCK
    rows (a block recomputes 21 rim rows beside its own)."""
    strips = -(-w // tile_w)
    down = max(1, min(slots // (3 * strips), h // MIN_ROWS_PER_BLOCK))
    rows = -(-h // down)
    return strips, rows, -(-h // rows)


def fused_photometric_walk(pred: torch.Tensor, target: torch.Tensor,
                           lambda_dssim: float = 0.2, threads: int = 32,
                           rows_per_block: int = 16):
    """(loss, grad) by the kernel's own schedule, in torch: one "block" per
    strip of ``threads`` columns (``threads - 20`` of them outputs) and
    ``rows_per_block`` rows, walking down a row a step with the two ring
    accumulators of ``csrc/ssim.cu`` (same step count, phases, validity
    tests and zero padding); the thread dimension is a tensor axis. For
    tests of the index logic at small sizes: it loops in Python."""
    lam = float(lambda_dssim)
    dt = pred.dtype
    _, h, w = pred.shape
    n = 3.0 * h * w
    win = [torch.tensor(v, dtype=dt) for v in _window()]
    tile_w = threads - 2 * HALO
    if tile_w <= 0:
        raise ValueError(f"threads must exceed {2 * HALO}, got {threads}")
    coef_scale, l1_scale = -lam / n, (1.0 - lam) / n
    grad = torch.zeros_like(pred)
    l1_sum = torch.zeros((), dtype=torch.float64)
    ss_sum = torch.zeros((), dtype=torch.float64)
    t = torch.arange(threads)

    def row(img, gy, gx, col_in):
        out = torch.zeros(threads, dtype=dt)
        if 0 <= gy < h:
            out[col_in] = img[gy, gx[col_in]]
        return out

    def along(buf):      # buf: [threads + 10] with 5 zero pads a side
        acc = torch.zeros(threads, dtype=dt)
        for j in range(WIN):
            acc = acc + win[j] * buf[j:j + threads]
        return acc

    for ch in range(3):
        x, y = pred[ch], target[ch]
        for oy in range(0, h, rows_per_block):
            rows = min(rows_per_block, h - oy)
            for ox in range(0, w, tile_w):
                gx = ox - HALO + t
                col_in = (gx >= 0) & (gx < w)
                owned = (t >= HALO) & (t < threads - HALO) & (gx < w)
                a1 = torch.zeros((5, WIN, threads), dtype=dt)
                a2 = torch.zeros((3, WIN, threads), dtype=dt)
                coef = torch.zeros((3, threads), dtype=dt)
                for s in range(rows + 2 * HALO + 1):
                    p = s % WIN
                    i = oy - HALO + s
                    xv, yv = row(x, i, gx, col_in), row(y, i, gx, col_in)
                    pad = torch.zeros(RAD, dtype=dt)
                    sx = torch.cat([pad, xv, pad])
                    sy = torch.cat([pad, yv, pad])
                    sc = [torch.cat([pad, c, pad]) for c in coef]
                    if oy <= i < oy + rows:
                        l1_sum += torch.abs(xv - yv)[owned].double().sum()
                    hs = [along(sx), along(sy), along(sx * sx),
                          along(sy * sy), along(sx * sy)]
                    for j in range(WIN):
                        slot = (p + RAD - j + WIN) % WIN
                        for m in range(5):
                            # Tap 0 opens the slot the step before read.
                            a1[m, slot] = win[j] * hs[m] + (
                                a1[m, slot] if j else 0.0)
                    d1 = (p + RAD + 1) % WIN
                    u, v, p2, q2, r2 = (a1[m, d1] for m in range(5))
                    o1 = i - RAD
                    coef = torch.zeros((3, threads), dtype=dt)
                    if s >= HALO and 0 <= o1 < h:
                        a_1 = 2.0 * (u * v) + C1
                        a_2 = 2.0 * (r2 - u * v) + C2
                        b_1 = u * u + v * v + C1
                        b_2 = torch.clamp_min(
                            (p2 - u * u) + (q2 - v * v) + C2, 0.5 * C2)
                        inv_b1, inv_b2 = 1.0 / b_1, 1.0 / b_2
                        inv_d = inv_b1 * inv_b2
                        smap = a_1 * a_2 * inv_d
                        full = torch.stack([
                            coef_scale * (2.0 * v * (a_2 - a_1) * inv_d
                                          - 2.0 * u * smap
                                          * (inv_b1 - inv_b2)),
                            coef_scale * (-smap * inv_b2),
                            coef_scale * (2.0 * a_1 * inv_d)])
                        coef = torch.where(col_in[None], full, coef)
                        if oy <= o1 < oy + rows:
                            ss_sum += smap[owned].double().sum()
                    gs = [along(c) for c in sc]
                    for j in range(WIN):
                        slot = (p + WIN - 1 - j) % WIN
                        for m in range(3):
                            a2[m, slot] = win[j] * gs[m] + (
                                a2[m, slot] if j else 0.0)
                    fu, fp, fr = (a2[m, p] for m in range(3))
                    if s > 2 * HALO:
                        o2 = i - HALO - 1
                        xo, yo = x[o2, gx[owned]], y[o2, gx[owned]]
                        grad[ch, o2, gx[owned]] = (
                            fu[owned] + 2.0 * xo * fp[owned]
                            + yo * fr[owned]
                            + l1_scale * torch.sign(xo - yo))
    loss = ((1.0 - lam) * l1_sum / n + lam * (1.0 - ss_sum / n)).to(dt)
    return loss, grad


@functools.lru_cache(maxsize=None)
def _grid_limits(device_index: int):
    """(output columns per strip, resident blocks on the device) of the
    built kernel."""
    lib = kernels.load("ssim")
    lib.ssim_tile_width.restype = ctypes.c_int
    lib.ssim_tile_width.argtypes = []
    with torch.cuda.device(device_index):
        per_sm, _ = kernels.occupancy("ssim")
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return lib.ssim_tile_width(), max(per_sm, 1) * n_sm


def _launch_ssim(pred: torch.Tensor, target: torch.Tensor, lam: float):
    lib = kernels.load("ssim")
    fn = lib.ssim_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_double] + [ctypes.c_void_p] * 6)
    _, h, w = pred.shape
    dev = pred.device
    index = (dev.index if dev.index is not None
             else torch.cuda.current_device())
    tile_w, slots = _grid_limits(index)
    strips, rows, down = plan_strips(h, w, tile_w, slots)
    partial = torch.empty((2 * 3 * strips * down,), dtype=torch.float64,
                          device=dev)
    grad = torch.empty_like(pred)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    # The blocks' ticket counter: the launch zeroes it on the stream.
    ticket = torch.empty((1,), dtype=torch.int32, device=dev)
    window = (ctypes.c_float * WIN)(*_window())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(pred.data_ptr(), target.data_ptr(), h, w, rows, lam,
                    ctypes.addressof(window), partial.data_ptr(),
                    ticket.data_ptr(), grad.data_ptr(), loss.data_ptr(),
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
