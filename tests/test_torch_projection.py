"""The projection's closed-form backward (``project_backward_plain``, the
formulas of ``csrc/project.cu``'s backward kernel) against autograd of
``project_plain``, and the kernel pair's wrapper on the CPU. Torch only.

Float64 on the CPU, so the two differ by rounding alone (1e-9 of each
row's largest gradient); the thin rows' long axis is raised to 10^14 -
10^17 there, so that the 2D determinant of some still rounds to <= 0.
Rows whose determinant is positive but below 1e-8 of a c, where it is
mostly rounding, have no well-conditioned gradient and are left out of
the comparison; those whose determinant is <= 0 are kept.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h3dgs_tpu_torch.ops import kernels
from h3dgs_tpu_torch.ops import projection as proj

from .torch_projection_cases import as_tensors, projection_case

torch.set_num_threads(2)

CASES = [(d, False, 1.0) for d in range(5)] + [(3, True, 1.0),
                                               (2, False, 0.7),
                                               (4, False, 1.3)]
OUTPUTS = ("means2d", "conic", "rgb", "depth")


def _cotangents(n, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s), dtype=torch.float64)
            for s in ((n, 2), (n, 3), (n, 3), (n,))]


def _rows_close(got, want, what, keep=None, rel=1e-9):
    """|got - want| <= rel x the row's largest |want| (and 1e-12 of the
    tensor's), row by row over the rows ``keep``; ``want`` None (unused by
    autograd) is zero."""
    if want is None:
        want = torch.zeros_like(got)
    if keep is not None:
        got, want = got[keep], want[keep]
    got = got.reshape(got.shape[0], -1)
    want = want.reshape(want.shape[0], -1)
    assert torch.isfinite(want).all(), what
    scale = want.abs().amax(dim=1) + 1e-12 * float(want.abs().max())
    err = (got - want).abs().amax(dim=1)
    assert bool((err <= rel * scale).all()), (
        what, float((err / scale.clamp_min(1e-300)).max()))


def _conditioned(g):
    """Rows kept in a comparison: det <= 0, or det > 1e-8 a c."""
    return ~g.det_ok | (g.det > 1e-8 * g.cov_a * g.cov_c)


@pytest.mark.parametrize("degree,precomp,mod", CASES)
def test_backward_plain_matches_autograd(degree, precomp, mod):
    """Each output's cotangent alone, then all four: the closed form equals
    autograd of ``project_plain`` row by row, over rows behind the near
    plane, past the tan clamp, with det <= 0, with a negative SH colour
    and under the opacity cull (each case is counted present)."""
    arrays, cam = projection_case(degree, seed=10 + degree, n=1200,
                                  extra_k=2, long_axis=(14.0, 17.0))
    n = arrays[0].shape[0]
    leaves = [t.requires_grad_(True) for t in as_tensors(arrays,
                                                         torch.float64)]
    means, scales, quats, opac, shs = leaves
    k = (degree + 1) ** 2
    colors = (torch.rand((n, 3), dtype=torch.float64, requires_grad=True)
              if precomp else None)
    out = proj.project_plain(means, scales, quats, opac, shs[:, :k], cam,
                             degree, mod, colors_precomp=colors)
    with torch.no_grad():
        g = proj._geometry(means, scales, quats, cam, mod)
        dirs = proj._view_dirs(g, cam)
        raw = proj._eval_sh_components(
            degree, shs[:, :k], *(d * dirs[4] for d in dirs[:3])) + 0.5
        assert int((~g.det_ok).sum()) > 0
        assert int((g.depth <= proj.NEAR_CULL_Z).sum()) > 0
        assert int((g.tqx.abs() > g.limx).sum()) > 0
        assert int((g.tqy.abs() > g.limy).sum()) > 0
        assert int((raw < 0).sum()) > 0
        assert int((opac < 1.0 / 255.0).sum()) > 0
        keep = _conditioned(g)
        assert int(keep.sum()) > 0.8 * n
    cots = _cotangents(n, degree)
    for only in list(range(4)) + [None]:
        use = [c if only in (None, i) else None for i, c in enumerate(cots)]
        terms = [(o * c).sum() for o, c in zip(
            (out.means2d, out.conic, out.rgb, out.depth), use)
            if c is not None]
        want = torch.autograd.grad(sum(terms), (means, scales, quats, shs),
                                   allow_unused=True, retain_graph=True)
        with torch.no_grad():
            got = proj.project_backward_plain(
                means, scales, quats, None if precomp else shs[:, :k], cam,
                degree, mod, *use)
        what = "all" if only is None else OUTPUTS[only]
        for name, gt, w in zip(("means3d", "scales", "quats"), got, want):
            _rows_close(gt, w, (what, name), keep)
        if precomp:
            assert got[3] is None and want[3] is None
        else:
            w_sh = torch.zeros_like(shs) if want[3] is None else want[3]
            _rows_close(got[3], w_sh[:, :k], (what, "shs"), keep)
            assert not bool(w_sh[:, k:].any())


def test_cpu_tensors_launch_nothing():
    """On CPU tensors ``project_gaussians`` is ``project_plain``: equal
    outputs and gradients, bit for bit, and no kernel launch counted."""
    arrays, cam = projection_case(3, seed=4, n=600)
    kernels.reset_launches()
    outs, grads = [], []
    for fn in (proj.project_gaussians, proj.project_plain):
        leaves = [t.requires_grad_(True) for t in as_tensors(arrays)]
        out = fn(*leaves, cam, 3, 0.9)
        cots = _cotangents(len(arrays[0]), 1)
        loss = sum((o * c.float()).sum() for o, c in zip(
            (out.means2d, out.conic, out.rgb, out.depth), cots))
        loss = loss + (out.opacity * 2.0).sum()
        loss.backward()
        outs.append(out)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


def _plain_launches(monkeypatch):
    """Replace the two launches by the plain versions, so that the
    autograd Function's routing runs on the CPU."""
    def fwd(means3d, scales, quats, opacities, shs, cam, width, height,
            degree, mod):
        c = proj.Camera(*cam, height=height, width=width)
        out = proj.project_plain(
            means3d, scales, quats, opacities, shs, c, max(degree, 0), mod,
            colors_precomp=means3d if degree < 0 else None)
        return (out.means2d, out.conic, None if degree < 0 else out.rgb,
                out.depth, out.radius, out.valid)

    def bwd(means3d, scales, quats, shs, cam, width, height, degree, mod,
            *cots):
        c = proj.Camera(*cam, height=height, width=width)
        return proj.project_backward_plain(
            means3d, scales, quats, shs if degree >= 0 else None, c, degree,
            mod, *cots)

    monkeypatch.setattr(proj, "_launch_fwd", fwd)
    monkeypatch.setattr(proj, "_launch_bwd", bwd)


@pytest.mark.parametrize("degree,precomp", [(3, False), (1, False),
                                            (2, True)])
def test_autograd_function_routes_gradients(monkeypatch, degree, precomp):
    """The kernels' ``torch.autograd.Function`` with the launches replaced
    by the plain versions: the gradients of every input (shs a row-strided
    slice of 16 coefficients, the opacity and given colours passing the
    Function by) equal autograd of ``project_plain``."""
    _plain_launches(monkeypatch)
    arrays, cam = projection_case(degree, seed=7, n=600,
                                  extra_k=16 - (degree + 1) ** 2)
    k = (degree + 1) ** 2
    n = arrays[0].shape[0]
    runs = []
    for route in ("function", "plain"):
        leaves = [t.requires_grad_(True) for t in as_tensors(
            arrays, torch.float64)]
        colors = (torch.linspace(0, 1, 3 * n, dtype=torch.float64)
                  .reshape(n, 3).requires_grad_(True) if precomp else None)
        means, scales, quats, opac, shs = leaves
        if route == "function":
            cam_t = proj._camera_args(cam, "cpu")
            out = proj._Project.apply(
                means, scales, quats, opac, None if precomp else shs[:, :k],
                *cam_t, cam.width, cam.height, -1 if precomp else degree,
                0.8)
            rgb = colors if precomp else out[2]
            m2d, conic, depth = out[0], out[1], out[3]
        else:
            ref = proj.project_plain(means, scales, quats, opac,
                                     shs[:, :k], cam, degree, 0.8,
                                     colors_precomp=colors)
            m2d, conic, rgb, depth = (ref.means2d, ref.conic, ref.rgb,
                                      ref.depth)
        cots = _cotangents(n, 3)
        loss = ((m2d * cots[0]).sum() + (conic * cots[1]).sum()
                + (rgb * cots[2]).sum() + (depth * cots[3]).sum()
                + (opac * opac).sum())
        loss.backward()
        runs.append([t.grad for t in leaves]
                    + [None if colors is None else colors.grad])
    # The thin rows' rotation gradients are ill-conditioned (axes 10^-6
    # to 10^4 apart); the routing is what this test holds.
    keep = torch.ones(n, dtype=torch.bool)
    keep[2 * (n // 6):3 * (n // 6)] = False
    for name, a, b in zip(("means3d", "scales", "quats", "opacities", "shs",
                           "colors"), *runs):
        if b is None:
            assert a is None, name
        else:
            _rows_close(a, b, name, keep)
