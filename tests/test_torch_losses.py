"""Parity of the port's losses (``utils/losses.py``) and fused photometric
loss (``ops/ssim.py``, kernel K3's plain version) with the JAX package, on
the same seeded numpy images. Values and pred-gradients are compared;
tolerances are stated per test."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h3dgs_tpu.ops import pallas_ssim as jssim
from h3dgs_tpu.utils import losses as jloss
from h3dgs_tpu_torch.ops import ssim as tssim
from h3dgs_tpu_torch.utils import losses as tloss

from .test_torch_common import np_, t_

torch.set_num_threads(2)


def _pair(seed, h=40, w=52, dark=False):
    rng = np.random.default_rng(seed)
    if dark:
        # Dark, low-variance images: blur(x^2) - mu^2 cancels (hazard H1).
        x = 0.02 + 0.002 * rng.random((3, h, w))
        y = 0.02 + 0.002 * rng.random((3, h, w))
    else:
        x = rng.random((3, h, w))
        y = np.clip(x + 0.15 * rng.normal(size=(3, h, w)), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


def _torch_value_and_grad(fn, x, y):
    xt = t_(x).requires_grad_(True)
    val = fn(xt, t_(y))
    val.backward()
    return float(val.detach()), np_(xt.grad)


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "psnr", "ssim",
                                  "photometric_loss"])
def test_loss_values_and_pred_gradients(name):
    """float32 shifted-add blurs in the same order: values within 1e-6,
    gradients within 1e-5 of their max."""
    x, y = _pair(1)
    jf = getattr(jloss, name)
    tf = getattr(tloss, name)
    jv, jg = jax.value_and_grad(lambda a: jf(a, jnp.asarray(y)))(
        jnp.asarray(x))
    tv, tg = _torch_value_and_grad(tf, x, y)
    np.testing.assert_allclose(tv, float(jv), rtol=1e-5, atol=1e-6)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("dark", [False, True])
def test_fused_plain_matches_xla_grad(dark):
    """``fused_photometric_plain``'s analytic gradient against jax.grad of
    the XLA loss; the dark case is H1 (no TF32, no cancellation blow-up).
    Loss within 1e-6, gradient within 1e-4 of its max (the b2 clamp never
    engages on these images)."""
    x, y = _pair(2, dark=dark)
    jv, jg = jax.value_and_grad(
        lambda a: jloss.photometric_loss(a, jnp.asarray(y), 0.2))(
        jnp.asarray(x))
    loss, grad = tssim.fused_photometric_plain(t_(x), t_(y), 0.2)
    assert abs(float(loss) - float(jv)) <= 1e-6
    scale = float(np.abs(np.asarray(jg)).max())
    assert np.abs(np_(grad) - np.asarray(jg)).max() <= 1e-4 * scale
    assert np.isfinite(np_(grad)).all()


def test_fused_plain_matches_pallas_interpret():
    """Against the Pallas kernel itself (interpret mode on the CPU), on a
    ragged multi-band image: loss within 1e-6, gradient within 1e-4 of
    its max."""
    x, y = _pair(3, h=jssim.BH + 9, w=37)
    jv, jg = jax.value_and_grad(
        lambda a: jssim.fused_photometric_loss(a, jnp.asarray(y), 0.3))(
        jnp.asarray(x))
    loss, grad = tssim.fused_photometric_plain(t_(x), t_(y), 0.3)
    assert abs(float(loss) - float(jv)) <= 1e-6
    scale = float(np.abs(np.asarray(jg)).max())
    assert np.abs(np_(grad) - np.asarray(jg)).max() <= 1e-4 * scale


def test_fused_loss_autograd_and_gate(monkeypatch):
    """The autograd Function differentiates pred only; the gate keeps the
    fused path off on the CPU unless asked for explicitly."""
    x, y = _pair(4, h=24, w=30)
    xt = t_(x).requires_grad_(True)
    yt = t_(y).requires_grad_(True)
    tssim.fused_photometric_loss(xt, yt, 0.2).backward()
    assert yt.grad is None
    _, want = tssim.fused_photometric_plain(t_(x), t_(y), 0.2)
    np.testing.assert_allclose(np_(xt.grad), np_(want), rtol=0, atol=0)

    assert tloss._FUSED_SSIM_VERIFIED is False
    assert not tloss.fused_ssim_supported(t_(x))        # CPU tensor
    monkeypatch.setenv("H3DGS_FUSED_SSIM", "1")
    calls = []
    monkeypatch.setattr(tssim, "fused_photometric_loss",
                        lambda *a: calls.append(a) or torch.zeros(()))
    tloss.photometric_loss(t_(x), t_(y))
    assert not calls                                    # auto: not on CPU
    tloss.photometric_loss(t_(x), t_(y), fused=True)
    assert len(calls) == 1


@pytest.mark.parametrize("h,w,threads,rows", [(11, 11, 32, 16),
                                              (23, 40, 24, 5),
                                              (30, 13, 40, 7)])
def test_fused_walk_matches_plain(h, w, threads, rows):
    """The kernel's walk (``fused_photometric_walk``: strips of
    ``threads`` columns, blocks of ``rows`` rows, a row a step, two ring
    accumulators) against the plain version in float64, at sizes that are
    no multiple of the strip or the block: loss and gradient within 1e-12
    (the two differ only in the order of the separable passes)."""
    x, y = _pair(h * w, h=h, w=w)
    xt, yt = t_(x).double(), t_(y).double()
    want_loss, want_grad = tssim.fused_photometric_plain(xt, yt, 0.2)
    loss, grad = tssim.fused_photometric_walk(xt, yt, 0.2, threads=threads,
                                              rows_per_block=rows)
    assert abs(float(loss) - float(want_loss)) <= 1e-12
    assert float((grad - want_grad).abs().max()) <= 1e-12
    assert float(want_grad.abs().max()) > 1e-5


@pytest.mark.parametrize("h,w", [(48, 64), (100, 130)])
def test_fused_walk_float32_within_reference_contract(h, w):
    """In float32 the walk's pass order (along the row first, the plain
    version's down the column first) rounds differently; on the uniform
    random images of the reference's kernel test
    (tests/test_pallas_ssim.py) the two stay within that test's bounds:
    loss 5e-7, gradient 5e-6 of its largest value."""
    rng = np.random.default_rng(h * 1000 + w)
    xt = t_(rng.uniform(0, 1, (3, h, w)).astype(np.float32))
    yt = t_(rng.uniform(0, 1, (3, h, w)).astype(np.float32))
    want_loss, want_grad = tssim.fused_photometric_plain(xt, yt, 0.2)
    loss, grad = tssim.fused_photometric_walk(xt, yt, 0.2)
    assert abs(float(loss) - float(want_loss)) <= 5e-7
    assert float((grad - want_grad).abs().max()) <= \
        5e-6 * float(want_grad.abs().max())


@pytest.mark.parametrize("h,w", [(900, 1600), (1080, 1920), (11, 11),
                                 (64, 64), (37, 2000)])
def test_plan_strips_covers_the_image(h, w):
    """The kernel's grid: the strips cover the width, the blocks the
    height with none empty, one wave of resident blocks where the image
    allows it, and no block of fewer than MIN_ROWS_PER_BLOCK rows unless
    the image is shorter."""
    tile_w, slots = 108, 3 * 132
    strips, rows, down = tssim.plan_strips(h, w, tile_w, slots)
    assert (strips - 1) * tile_w < w <= strips * tile_w
    assert (down - 1) * rows < h <= down * rows
    assert rows >= min(h, tssim.MIN_ROWS_PER_BLOCK)
    assert 3 * strips * down <= max(slots, 3 * strips)
