"""The counting functions on hand-worked cases."""
from __future__ import annotations

import pytest
import torch

from _tiny import ROOT  # noqa: F401  (puts the repository on the path)
from benchmark.reference import render
from benchmark.work import blend_bwd, blend_fwd, frame, peaks, train_step


def test_least_time_names_its_bound():
    t, bound = peaks.least_time(67e12, 1.0)
    assert t == pytest.approx(1.0) and bound == "operations"
    t, bound = peaks.least_time(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and bound == "bytes"


def test_blend_forward_work():
    ops, nbytes = blend_fwd.work(pairs=10, splats=2, entries=3, pixels=256)
    assert ops == 200
    assert nbytes == 40 * 2 + 4 * 3 + 8 * 1 + 24 * 256


def test_blend_backward_work():
    ops, nbytes = blend_bwd.work(pairs=10, contrib=4, splats=2, entries=3,
                                 pixels=512)
    assert ops == 20 * 10 + 40 * 4
    assert nbytes == 80 * 2 + 4 * 3 + 8 * 2 + 28 * 512


def test_frame_and_step_ops():
    assert frame.ops(nodes=1, cut=0, pairs=0) == 20 + 3 * 18
    assert frame.ops(nodes=0, cut=1, pairs=1) == 185 + 320 + 20
    assert train_step.ops(1, 0, 0, 0, 0) == 320 + 640 + 12 + 12 * 59 + 6
    assert train_step.ops(0, 1, 1, 1, 1) == 3 * 400 + 24 + 20 + 20 + 40


def test_pairs_of_a_hand_worked_tile():
    """Twenty flat splats of opacity 0.5 over one 16 x 16 tile: each pixel
    evaluates entries while the transmittance before them is >= 1e-4
    (0.5^k, k <= 13: 14 entries); the last that contributes is entry 12
    (0.5^13 after it is still >= 1e-4), so the backward walks 13."""
    n = 20
    p = render.Projected(
        means2d=torch.full((n, 2), 8.0), conic=torch.zeros((n, 3)),
        rgb=torch.full((n, 3), 0.5), opacity=torch.full((n,), 0.5),
        depth=torch.arange(1.0, n + 1.0), radius=torch.full((n,), 30,
                                                            dtype=torch.int32),
        valid=torch.ones(n, dtype=torch.bool))
    binned = render.Binned(torch.arange(n), torch.zeros(1, dtype=torch.long),
                           torch.full((1,), n))
    color, invd, final_t, last, evaluated = render.blend(p, binned, 16, 16)
    assert int(evaluated.sum()) == 14 * 256
    assert bool((last == 12).all())
    g = torch.ones((3, 16, 16))
    out = render.blend_backward(p, binned, color, invd, final_t, last, g,
                                torch.zeros((1, 16, 16)),
                                torch.zeros((16, 16)), 16, 16)
    assert out[5] == 13 * 256 and out[6] == 13 * 256
