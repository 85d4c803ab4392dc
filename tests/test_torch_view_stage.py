"""A training view's wire format (``scene/views.py``: ``stage_view`` in
the decode pool, ``staged_to_device``): a record decoded on the device
equals the host view after the quantisation the format states, bit for
bit; the prefetcher's device views from a ``ViewStream`` over committed
fixtures equal that, each view's record is one buffer on the device, and
the counter ``view.staged`` adds 1 a view. Torch only."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from h3dgs_tpu_torch.scene import loader
from h3dgs_tpu_torch.scene.dataset import CameraInfo
from h3dgs_tpu_torch.scene import views
from h3dgs_tpu_torch.train import loop as tloop
from h3dgs_tpu_torch.utils import profiling

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEPTH = {"scale": 1.5, "offset": 0.01, "med_scale": 1.2}
# A scale more than 5x the median: the depth map is read, judged
# unreliable, and its mask is zero.
UNRELIABLE = {"scale": 7.0, "offset": 0.01, "med_scale": 1.2}
VIEWS = {
    "mask": ("torch_jpeg/pil_420_q90_257x129.jpg", "torch_png/c0_d8_37x41.png",
             "torch_png/c0_d16_37x41.png", DEPTH),
    "no_depth": ("torch_jpeg/pil_444_q90_13x17.jpg", "", "", None),
    "unreliable": ("torch_jpeg/gray_97x61.jpg", "",
                   "torch_png/c0_d16_37x41.png", UNRELIABLE),
    "other_size": ("torch_jpeg/pil_422_q50_61x97.jpg",
                   "torch_png/c0_d1_37x41.png",
                   "torch_png/c0_d16_adam7_37x41.png", DEPTH),
}
# (views of the stream, in order; views a step)
CASES = {
    "mask": (["mask"], 1),
    "no_depth": (["no_depth"], 1),
    "unreliable_depth": (["unreliable"], 1),
    "two_sizes": (["mask", "other_size"], 1),
    "views_per_step_2": (["mask", "no_depth", "unreliable"], 2),
}


def _info(name):
    image, mask, depth, params = VIEWS[name]

    def path(p):
        return os.path.join(DATA, p) if p else ""

    return CameraInfo(uid=0, R=np.eye(3), T=np.array([0.1, -0.2, 3.0]),
                      fovx=1.1, fovy=0.7, primx=0.5, primy=0.5, width=0,
                      height=0, image_path=path(image), image_name=name,
                      mask_path=path(mask), depth_path=path(depth),
                      depth_params=params)


def _leaves(b):
    cam = b.camera
    return {**{k: getattr(cam, k) for k in views._CAMERA},
            **{k: getattr(b, k) for k in ("gt_image", "alpha_mask",
                                          "invdepth", "depth_mask",
                                          "depth_reliable", "image_idx")}}


def assert_bit_equal(got, want):
    assert (got.camera.height, got.camera.width) == (want.camera.height,
                                                     want.camera.width)
    g, w = _leaves(got), _leaves(want)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert g[k].device == w[k].device, k
        assert torch.equal(g[k], w[k]), k


def _run(case, tmp_path, steps=3):
    names, per_step = CASES[case]
    infos = [_info(n) for n in names]
    stream = loader.ViewStream(infos, "cpu", num_workers=2, shuffle=False)
    pf = tloop.BatchedPrefetcher(stream, per_step, "cpu")
    try:
        with profiling.trace(str(tmp_path)):
            got = [next(pf) for _ in range(steps)]
    finally:
        stream.close()
    return infos, got, profiling.snapshot()


def q8(x) -> np.ndarray:
    """The wire format's 8 bits: clip(x * 255 + 0.5) truncated, in
    ``x``'s own precision."""
    return np.clip(np.asarray(x) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def wire(view):
    """The float32 view the steps receive for a host view, as the wire
    format states it: images and masks through 8 bits, inverse depth
    through f16, the camera and ``image_idx`` as they are,
    ``depth_reliable`` a bool."""
    def eight(x):
        return torch.from_numpy(q8(x)).float() / 255

    return views.ViewBatch(
        camera=view.camera, gt_image=eight(view.gt_image),
        alpha_mask=eight(view.alpha_mask),
        invdepth=torch.from_numpy(
            np.asarray(view.invdepth, np.float16)).float(),
        depth_mask=eight(view.depth_mask),
        depth_reliable=torch.tensor(bool(view.depth_reliable)),
        image_idx=torch.as_tensor(np.asarray(view.image_idx, np.int64)))


DECODED = ("gt_image", "alpha_mask", "invdepth", "depth_mask")


@pytest.mark.parametrize("case", list(CASES))
def test_prefetched_views_equal_todays_route(case, tmp_path):
    """Three steps of the prefetcher over a ``ViewStream`` (shuffle off,
    so view k of the stream is ``infos[k % n]``): each step's host views
    are the loader's, and its device views are the wire format's float32
    views of them (``wire``), bit for bit, leaf by leaf. The leaves the
    device does not decode share one buffer, the view's copied
    record."""
    infos, got, snap = _run(case, tmp_path)
    per_step = CASES[case][1]
    k = 0
    for hosts, devs in got:
        assert len(hosts) == len(devs) == per_step
        for host, dev in zip(hosts, devs):
            i = k % len(infos)
            view = loader.load_view(infos[i], -1, image_idx=i)
            assert int(host.image_idx) == i
            np.testing.assert_array_equal(host.gt_image, view.gt_image)
            assert_bit_equal(dev, wire(view))
            leaves = _leaves(dev)
            ptrs = {t.untyped_storage().data_ptr() for k_, t in
                    leaves.items() if k_ not in DECODED}
            assert len(ptrs) == 1
            k += 1
    # The prefetcher runs a step ahead: the three calls launched steps
    # 2-4, whose views the counter saw.
    n = 3 * per_step
    assert snap["counters"]["view.staged"] == {"total": n, "samples": n}
    assert "view.encode" not in {s[0] for s in snap["spans"]}


@pytest.mark.parametrize("name", list(VIEWS))
def test_stage_view_record(name):
    """``stage_view`` alone: every leaf sits at a multiple of 256 bytes
    in one uint8 record sized from the view's own shape, unpinned here
    (no card), and ``staged_to_device`` of it on the CPU is the host view
    after the wire format's quantisation (``wire``), bit for bit."""
    view = loader.load_view(_info(name), -1, image_idx=5)
    # What each fixture stands for.
    masked = not np.all(view.alpha_mask == 1.0)
    assert masked == (name in ("mask", "other_size"))
    assert bool(view.depth_reliable) == (name in ("mask", "other_size"))
    assert bool(view.invdepth.any()) == (name != "no_depth")
    assert bool(view.depth_mask.any()) == bool(view.depth_reliable)
    staged = views.stage_view(view, pin=False)
    assert staged.host is view and staged.record.dtype == torch.uint8
    assert not staged.record.is_pinned()
    ends = []
    for k, dtype, shape, off in staged.fields:
        assert off % 256 == 0, k
        ends.append(off + dtype.itemsize * int(np.prod(shape)))
    assert staged.record.numel() == max(ends)
    h, w = view.camera.height, view.camera.width
    assert dict((k, s) for k, _, s, _ in staged.fields)["gt_image"] == \
        (3, h, w)
    assert_bit_equal(views.staged_to_device(staged, "cpu"), wire(view))
