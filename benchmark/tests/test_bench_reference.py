"""The plain reference against the port's CPU path at a tiny size: the
renderer piece by piece, and whole cells (a sound tiny run is correct)."""
from __future__ import annotations


import numpy as np
import pytest
import torch

from _tiny import run_in_process


def _splats(n=400, seed=0):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.randn((n, 3), generator=g) * 0.8
    xyz[:, 2] += 4.0
    scales = torch.exp(torch.rand((n, 3), generator=g) * 1.5 - 3.5)
    quats = torch.randn((n, 4), generator=g)
    opac = 0.2 + 0.75 * torch.rand(n, generator=g)
    shs = torch.randn((n, 16, 3), generator=g) * 0.3
    return xyz, scales, quats, opac, shs


def _cams(w=80, h=48):
    from benchmark.reference import camera as rcam
    from h3dgs_tpu_torch.scene.camera import look_at_camera
    eye, target = (0.3, -0.4, -0.5), (0.0, 0.1, 4.0)
    fovy = rcam.fovy_of(1.1, w, h)
    rows, t = rcam.look_at(eye, target)
    ref = rcam.make_cam(rows, t, 1.1, fovy, w, h, "cpu")
    port = look_at_camera(eye=eye, target=target, fovx=1.1, fovy=fovy,
                          width=w, height=h)
    return ref, port


def test_render_matches_port():
    from benchmark.reference import render
    from h3dgs_tpu_torch.ops.rasterize import rasterize
    ref_cam, port_cam = _cams()
    args = _splats()
    bg = torch.tensor([0.1, 0.2, 0.3])
    want = rasterize(*args, port_cam, 3, bg)
    img, invd, p = render.rasterize(*args, ref_cam, 3, bg)
    assert torch.equal(p.radius, want["radii"])
    assert float((img - want["render"]).abs().max()) < 1e-5
    assert float((invd - want["invdepth"]).abs().max()) < 1e-5


def test_backward_matches_port():
    from benchmark.reference import render
    from h3dgs_tpu_torch.ops.rasterize import rasterize
    ref_cam, port_cam = _cams()
    bg = torch.zeros(3)
    a = [t.clone().requires_grad_(True) for t in _splats()]
    b = [t.clone().requires_grad_(True) for t in _splats()]
    out = rasterize(*a, port_cam, 3, bg)
    img, invd, _ = render.rasterize(*b, ref_cam, 3, bg)
    w = torch.linspace(0.5, 1.5, img.numel()).reshape(img.shape)
    ga = torch.autograd.grad((out["render"] * w).sum()
                             + out["invdepth"].sum(), a)
    gb = torch.autograd.grad((img * w).sum() + invd.sum(), b)
    for x, y in zip(ga, gb):
        scale = float(x.abs().max()) or 1.0
        assert float((x - y).abs().max()) <= 1e-4 * scale


def test_serve_reference_matches_renderer():
    from benchmark.paths import serve as sp
    from benchmark.reference import camera as rcam
    from benchmark.reference import serve as rserve
    from h3dgs_tpu_torch.hierarchy.tree import Hierarchy
    from h3dgs_tpu_torch.viewer import service
    from h3dgs_tpu_torch.viewer.network_gui import NetworkGUI
    import json
    cfg = dict(chunks=2, gaussians_per_chunk=2000, chunk_half=3.0,
               color_noise=0.0, pos_noise=0.02, rest_std=0.05, width=96,
               height=64, fov_x=1.2, tau=2.0, budget_mb=16000)
    walk = dict(walk_low=1.2, walk_high=6.0, walk_step=0.08)
    hier = sp.make_hierarchy(cfg, 7, "cpu")
    host = Hierarchy(**{k: v.numpy() for k, v in hier.items()},
                     anchors=np.zeros(0, np.int32))
    service.read_hier, orig = (lambda _p: host), service.read_hier
    try:
        r = service.HierarchyRenderer("x", budget=1 << 30, device="cpu")
    finally:
        service.read_hier = orig
    budget = sp.budget_splats(cfg, host.n_nodes)
    for pose in sp.walk_poses(cfg, walk)[::37]:
        cam = NetworkGUI._camera_from_msg(json.loads(sp.request_body(pose,
                                                                     cfg)))
        got, _ = r.render(cam, cfg["tau"])
        rows, t, fovx, fovy = sp.camera_of(pose, cfg)
        want, _ = rserve.frame(hier, rcam.make_cam(rows, t, fovx, fovy, 96,
                                                   64, "cpu"),
                               cfg["tau"], budget)
        diff = np.abs(got.astype(int) - want.numpy().astype(int))
        assert (diff.max(axis=-1) > 2).mean() < 1e-3


@pytest.mark.parametrize("workload", ["train_chunk", "serve_walk",
                                      "post_chunk", "serve_look"])
def test_sound_tiny_run_is_correct(workload):
    line = run_in_process(workload)
    assert line["correct"] is True, line["compared"]
