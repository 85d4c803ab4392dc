"""The pixels a JPEG decoder gives for the views' coefficients
(``core/jpeg.coefficients``), as libjpeg-turbo gives them by default:
dequantisation, jidctint.c's ISLOW integer IDCT with its range limit,
jdsample.c's "fancy" 2x2 triangle upsampling of the chroma, and
jdcolor.c's fixed-point YCbCr -> RGB. Plain torch in integers, so it
runs on the card beside the rest of the reference."""
from __future__ import annotations

import torch

# jidctint.c's constants, FIX(x) at 13 bits.
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_pass(x: torch.Tensor, shift: int) -> torch.Tensor:
    """jidctint.c's butterfly along the last-but-one axis of ``x`` [...,
    8, k] int64, descaled by ``shift``."""
    f = _F
    z2, z3 = x[..., 2, :], x[..., 6, :]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 - z3 * f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    z2, z3 = x[..., 0, :], x[..., 4, :]
    tmp0 = (z2 + z3) << 13
    tmp1 = (z2 - z3) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[..., 7, :], x[..., 5, :], x[..., 3, :], x[..., 1, :]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f["f1175"]
    o0, o1 = o0 * f["f0298"], o1 * f["f2053"]
    o2, o3 = o2 * f["f3072"], o3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    rnd = 1 << (shift - 1)
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
           t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return torch.stack([(v + rnd) >> shift for v in out], dim=-2)


def samples(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """[by, bx, 64] natural-order coefficients -> [by * 8, bx * 8] int64
    samples in 0..255."""
    by, bx = coef.shape[:2]
    x = (coef.long() * quant.long()).reshape(by, bx, 8, 8)
    ws = _idct_pass(x, 13 - 2)                             # columns
    out = _idct_pass(ws.transpose(-1, -2), 13 + 2 + 3)     # rows
    out = out.transpose(-1, -2)                            # [.., row, col]
    out = (((out + 512) & 1023) - 512 + 128).clamp(0, 255)
    return out.permute(0, 2, 1, 3).reshape(by * 8, bx * 8)


def upsample_h2v2(x: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """A chroma plane's real [ceil(H/2), ceil(W/2)] samples at the full
    size: column sums of 3 x the nearer row and the next nearer (edge
    rows repeated), then 3 x the nearer sum and the next nearer column
    (edge columns repeated), rounded with 8 and 7."""
    dh, dw = -(-height // 2), -(-width // 2)
    x = x[:dh, :dw]
    rows = torch.empty((2 * dh, dw), dtype=torch.int64, device=x.device)
    rows[0::2] = 3 * x + torch.cat([x[:1], x[:-1]])
    rows[1::2] = 3 * x + torch.cat([x[1:], x[-1:]])
    left = torch.cat([rows[:, :1], rows[:, :-1]], 1)
    right = torch.cat([rows[:, 1:], rows[:, -1:]], 1)
    out = torch.empty((2 * dh, 2 * dw), dtype=torch.int64, device=x.device)
    out[:, 0::2] = (3 * rows + left + 8) >> 4
    out[:, 1::2] = (3 * rows + right + 7) >> 4
    return out[:height, :width]


def pixels(coef: dict) -> torch.Tensor:
    """[H, W, 3] uint8: the decoded view."""
    w, h, q = coef["width"], coef["height"], coef["quant"]
    y = samples(coef["y"], q[0])[:h, :w]
    cb = upsample_h2v2(samples(coef["cb"], q[1]), w, h)
    cr = upsample_h2v2(samples(coef["cr"], q[1]), w, h)
    fix = lambda v: int(v * 65536.0 + 0.5)  # noqa: E731
    half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)
