"""A run whose timed path is broken underneath comes out not correct:
one case per fault the cell can have (a step that returns its state
unchanged, half of each view left out of the loss, a frame altered where
it is produced; one card, so no exchange between cards)."""
from __future__ import annotations

import pytest

from _tiny import run_in_process


def _unchanged_update(monkeypatch):
    import h3dgs_tpu_torch.parallel.step as dp
    make = dp.make_update

    def factory(*a, **k):
        make(*a, **k)

        def update(state, opt, exposure, exposure_opt, *rest):
            return state, opt, exposure, exposure_opt
        return update
    monkeypatch.setattr(dp, "make_update", factory)


def _unchanged_post_update(monkeypatch):
    import h3dgs_tpu_torch.parallel.step as dp
    make = dp.make_post_update

    def factory(*a, **k):
        make(*a, **k)

        def update(state, opt, *rest):
            return state, opt
        return update
    monkeypatch.setattr(dp, "make_post_update", factory)


def _half_view(monkeypatch):
    from h3dgs_tpu_torch.utils import losses
    orig = losses.photometric_loss

    def half(pred, target, *a, **k):
        rows = pred.shape[1] // 2
        return orig(pred[:, :rows], target[:, :rows], *a, **k)
    monkeypatch.setattr(losses, "photometric_loss", half)


def _altered_frame(monkeypatch):
    from h3dgs_tpu_torch.viewer import service
    orig = service.HierarchyRenderer._splat

    def splat(self, *a, **k):
        img = orig(self, *a, **k)
        return img.flip(0).contiguous()
    monkeypatch.setattr(service.HierarchyRenderer, "_splat", splat)


@pytest.mark.parametrize("workload,plant", [
    ("train_chunk", _unchanged_update),
    ("train_chunk", _half_view),
    ("post_chunk", _unchanged_post_update),
    ("post_chunk", _half_view),
    ("serve_walk", _altered_frame),
    ("serve_look", _altered_frame),
])
def test_fault_is_caught(monkeypatch, workload, plant):
    plant(monkeypatch)
    line = run_in_process(workload)
    assert line["correct"] is False
    over = [k for k, v in line["compared"].items()
            if v["value"] is None or v["value"] > v["limit"]]
    assert over, line["compared"]
