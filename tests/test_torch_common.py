"""Shared helpers for the PyTorch port's parity tests, plus the port-wide
guards: no module of ``h3dgs_tpu_torch`` (nor ``chip_smoke.py``) imports
JAX or the JAX package, and the entry points refuse to run without CUDA
unless a device is asked for.

Parity tests feed the same numpy inputs (made from a seed) to a JAX
function and to its port on ``device="cpu"`` and compare the results.
"""
from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from h3dgs_tpu.scene import camera as jcam_lib
from h3dgs_tpu_torch.scene import camera as tcam_lib

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "h3dgs_tpu_torch")


def np_(x) -> np.ndarray:
    """Tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (a copy)."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def camera_pair(eye, target=(0.0, 0.0, 0.0), fovx=1.0, width=64,
                height=48):
    """The same look-at camera in both packages: (jax, torch)."""
    kw = dict(eye=eye, target=target, fovx=fovx, width=width, height=height)
    return jcam_lib.look_at_camera(**kw), tcam_lib.look_at_camera(**kw)


def scene_tensors(means, scales, quats, opac, shs):
    return tuple(t_(a, torch.float32) for a in (means, scales, quats, opac,
                                                 shs))


def write_hier_pair(tmp_path, n=150, seed=0, sh_degree=1):
    """A random-scene hierarchy written by the JAX package. Returns
    (path, hierarchy)."""
    from h3dgs_tpu.hierarchy import tree as jtree
    from h3dgs_tpu.hierarchy.io import write_hier

    from .utils import random_scene

    means, scales, quats, opac, shs = random_scene(n, seed,
                                                   sh_degree=sh_degree)
    h = jtree.build_hierarchy(means, shs, opac, np.log(scales), quats,
                              backend="numpy")
    path = os.path.join(str(tmp_path), "merged.hier")
    write_hier(path, h)
    return path, h


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return sorted(files)


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package, at any nesting level."""
    files = _port_sources()
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "h3dgs_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} imports {name}")
    assert not bad, bad


def test_entry_points_need_cuda_or_a_device(tmp_path, monkeypatch):
    """Without CUDA and without an explicit device, the entry points raise
    instead of falling back to the CPU."""
    from h3dgs_tpu_torch.model.state import from_arrays
    from h3dgs_tpu_torch.render import render_post
    from h3dgs_tpu_torch.viewer import service

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, h = write_hier_pair(tmp_path, n=20, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        service.HierarchyRenderer(path, sh_degree=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        service.main(["--hierarchy", path, "--orbit_dir",
                      os.path.join(str(tmp_path), "frames")])
    state = from_arrays(h.xyz, h.shs[:, :1], h.shs[:, 1:], h.alpha,
                        h.scaling, h.rotation, opacity_abs=True,
                        skybox_last=True)
    _, cam = camera_pair((0, -0.5, -8.0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_post(cam, state, h.nodes, h.boxes, 0.05, np.zeros(3),
                    max_cut=h.n_nodes)
    # Asking for the CPU works.
    r = service.HierarchyRenderer(path, sh_degree=1, device="cpu")
    img, _ = r.render(cam, tau=3.0)
    assert img.shape == (48, 64, 3)


def test_unported_options_raise(tmp_path):
    from h3dgs_tpu_torch.viewer import service

    path, _ = write_hier_pair(tmp_path, n=20, seed=2)
    with pytest.raises(NotImplementedError):
        service.HierarchyRenderer(path, n_bands=2, device="cpu")
    with pytest.raises(NotImplementedError):
        service.main(["--hierarchy", path, "--web_port", "8080",
                      "--device", "cpu"])


def test_blend_backward_runs():
    """The blend is differentiable: on CPU tensors its autograd backward
    runs K2's plain version and equals ``blend_backward_plain``."""
    from h3dgs_tpu_torch.ops.blend import blend_backward_plain, blend_forward

    means2d = torch.tensor([[8.0, 8.0], [5.0, 9.0]], requires_grad=True)
    conic = torch.tensor([[0.1, 0.0, 0.1], [0.2, 0.05, 0.15]],
                         requires_grad=True)
    rgb = torch.tensor([[0.5, 0.5, 0.5], [0.9, 0.1, 0.3]],
                       requires_grad=True)
    opac = torch.tensor([0.8, 0.6], requires_grad=True)
    invd = torch.tensor([0.5, 0.25], requires_grad=True)
    idx = (torch.tensor([1, 0], dtype=torch.int32),
           torch.tensor([0], dtype=torch.int32),
           torch.tensor([2], dtype=torch.int32))
    color, inv, final_t, _ = blend_forward(means2d, conic, rgb, opac, invd,
                                           *idx, 16, 16)
    g = torch.linspace(-1.0, 1.0, 3 * 256).reshape(3, 16, 16)
    gd = torch.full((1, 16, 16), 0.3)
    gt = torch.full((16, 16), -0.2)
    ((color * g).sum() + (inv * gd).sum() + (final_t * gt).sum()).backward()
    want = blend_backward_plain(means2d.detach(), conic.detach(),
                                rgb.detach(), opac.detach(), invd.detach(),
                                *idx, color.detach(), inv.detach(),
                                final_t.detach(), g, gd, gt, 16, 16)
    for t, w in zip((means2d, conic, rgb, opac, invd), want):
        assert float(t.grad.abs().max()) > 0
        np.testing.assert_allclose(np_(t.grad), np_(w), rtol=1e-6,
                                   atol=1e-7)
