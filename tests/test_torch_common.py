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
import re

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


BANNED_ROOTS = ("jax", "jaxlib", "h3dgs_tpu")
# A module of the JAX package named in a string ("-m h3dgs_tpu.cli.x"):
# "h3dgs_tpu." not preceded by a name character or a dot.
JAX_MODULE_IN_STRING = re.compile(r"(?<![\w.])h3dgs_tpu\.")
_SUBPROCESS_CALLS = ("run", "Popen", "call", "check_call", "check_output")


def _banned(name) -> bool:
    return (isinstance(name, str)
            and name.split(".")[0].strip() in BANNED_ROOTS)


def _const(node):
    return node.value if isinstance(node, ast.Constant) else None


def jax_references(source: str, path: str = "<src>") -> list:
    """Where ``source`` imports jax or the JAX package, names a module of
    the JAX package in a string literal, imports one through
    ``importlib.import_module`` / ``__import__``, or starts one in a child
    process (``-m <module>`` or ``-c <code>`` in an argument list)."""
    bad = []

    def flag(node, what):
        bad.append(f"{path}:{getattr(node, 'lineno', 0)} {what}")

    for node in ast.walk(ast.parse(source, path)):
        if isinstance(node, ast.Import):
            for a in node.names:
                if _banned(a.name):
                    flag(node, f"imports {a.name}")
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _banned(node.module or ""):
                flag(node, f"imports {node.module}")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if JAX_MODULE_IN_STRING.search(node.value):
                flag(node, f"names a JAX module in {node.value[:60]!r}")
        elif isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else "")
            if (name in ("import_module", "__import__") and node.args
                    and _banned(_const(node.args[0]))):
                flag(node, f"{name}({_const(node.args[0])!r})")
            if name in _SUBPROCESS_CALLS or name.startswith("exec"):
                for arg in node.args:
                    elts = getattr(arg, "elts", None) or []
                    for flag_node, nxt in zip(elts, elts[1:]):
                        opt, val = _const(flag_node), _const(nxt)
                        if opt == "-m" and _banned(val):
                            flag(node, f"starts -m {val}")
                        elif opt == "-c" and isinstance(val, str) and \
                                jax_references(val, "-c"):
                            flag(node, f"starts -c {val[:60]!r}")
    return bad


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package (at any nesting level, also through importlib), names a module
    of the JAX package in a string, or starts one in a child process."""
    files = _port_sources()
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            bad += jax_references(f.read(), os.path.relpath(path, REPO))
    assert not bad, bad


@pytest.mark.parametrize("source,caught", [
    ("import jax.numpy as jnp", True),
    ("from h3dgs_tpu.hierarchy import tree", True),
    ("def f():\n    from jax import lax", True),
    ("cmd = [py, '-m', 'h3dgs_tpu.cli.train_single', '-s', src]", True),
    ("x = 'python -m h3dgs_tpu.cli.full_train --project_dir p'", True),
    ("import importlib\nm = importlib.import_module('h3dgs_tpu')", True),
    ("m = __import__('jax')", True),
    ("subprocess.run([sys.executable, '-m', 'h3dgs_tpu'])", True),
    ("subprocess.Popen([py, '-c', 'import jax; print(1)'])", True),
    ("cmd = [py, '-m', 'h3dgs_tpu_torch.cli.train_single']", False),
    ("from h3dgs_tpu_torch.hierarchy import tree", False),
    ("doc = 'counterpart of h3dgs_tpu/cli/full_train.py'", False),
    ("subprocess.run([py, '-c', 'import torch'])", False),
])
def test_import_guard_catches(source, caught):
    """The guard's own cases: each way of reaching the JAX package is
    flagged, the port's own names are not."""
    assert bool(jax_references(source)) == caught, source


def test_entry_points_need_cuda_or_a_device(tmp_path, monkeypatch):
    """Without CUDA and without an explicit device, the entry points raise
    instead of falling back to the CPU."""
    from h3dgs_tpu_torch.cli import render_hierarchy
    from h3dgs_tpu_torch.eval import metrics
    from h3dgs_tpu_torch.model.state import from_arrays
    from h3dgs_tpu_torch.render import render, render_post
    from h3dgs_tpu_torch.viewer import service

    from .utils import write_random_lpips_weights

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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render(cam, state, np.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_hierarchy.main(["-s", str(tmp_path), "--hierarchy", path,
                               "-m", os.path.join(str(tmp_path), "eval")])
    weights = write_random_lpips_weights(tmp_path / "lpips.npz")
    img = np.full((3, 16, 16), 0.5, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        metrics.lpips(img, img, weights_path=weights)
    assert metrics.lpips(img, img, weights_path=weights, device="cpu") == 0
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
