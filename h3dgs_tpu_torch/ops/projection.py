"""Gaussian projection: 3D -> screen-space splats (torch), and its CUDA
kernel pair's wrapper.

Counterpart of ``h3dgs_tpu/ops/projection.py``: view/projection
transform, EWA covariance projection with low-pass dilation, conic +
radius, SH -> RGB. Same numerical conventions as the 3DGS-family CUDA
preprocess (tan-clamped Jacobian, +0.3 px dilation, radius =
ceil(3 sqrt(lambda_max)), z < 0.2 near cull, opacity cull at 1/255,
ndc2pix = ((ndc+1)*size-1)/2), written per component as the reference
writes it so the two agree to float32 rounding.

``project_gaussians`` runs ``project_plain`` for CPU tensors. For CUDA
tensors it launches ``csrc/project.cu`` or raises: the forward is one
launch (``project_fwd``), and under autograd the backward is one more
(``project_bwd``), which recomputes the forward's terms from the inputs
and saves nothing per row. ``project_backward_plain`` is that backward's
closed form in plain torch (torch's subgradients: a clamp passes the
gradient inside its closed range, ``det <= 0`` blocks it), which the CPU
tests hold against autograd of ``project_plain``.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from ..scene.camera import Camera
from ..utils import sh as sh_utils
from ..utils import transforms
from . import kernels

# Splats closer than this are culled.
NEAR_CULL_Z = 0.2
# Low-pass dilation added to the projected 2D covariance diagonal (pixels^2).
COV2D_DILATION = 0.3


def _sh_basis(degree: int, x, y, z):
    """The SH basis values at decomposed [N] direction components, in the
    coefficient order of the ``[N, K, 3]`` layout (the first is the
    constant C0)."""
    if not (0 <= degree <= 4):
        raise ValueError(f"unsupported SH degree {degree}")
    C0, C1 = sh_utils.SH_C0, sh_utils.SH_C1
    C2, C3, C4 = sh_utils.SH_C2, sh_utils.SH_C3, sh_utils.SH_C4
    basis = [C0]
    if degree >= 1:
        basis += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                  C2[3] * xz, C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z,
                  C3[2] * y * (4.0 * zz - xx - yy),
                  C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  C3[4] * x * (4.0 * zz - xx - yy),
                  C3[5] * z * (xx - yy), C3[6] * x * (xx - 3.0 * yy)]
    if degree >= 4:
        basis += [C4[0] * xy * (xx - yy), C4[1] * yz * (3.0 * xx - yy),
                  C4[2] * xy * (7.0 * zz - 1.0),
                  C4[3] * yz * (7.0 * zz - 3.0),
                  C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
                  C4[5] * xz * (7.0 * zz - 3.0),
                  C4[6] * (xx - yy) * (7.0 * zz - 1.0),
                  C4[7] * xz * (xx - 3.0 * yy),
                  C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy))]
    return basis


def _sh_basis_grad(degree: int, x, y, z, gb):
    """(d/dx, d/dy, d/dz) of sum_i gb[i] * basis[i] (``gb[0]`` unused: the
    constant has none). ``csrc/project.cu:sh_basis_grad`` is the same
    table."""
    C1 = sh_utils.SH_C1
    C2, C3, C4 = sh_utils.SH_C2, sh_utils.SH_C3, sh_utils.SH_C4
    gx = gy = gz = 0.0
    if degree >= 1:
        gx = -C1 * gb[3]
        gy = -C1 * gb[1]
        gz = C1 * gb[2]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        gx = (gx + C2[0] * y * gb[4] - 2.0 * C2[2] * x * gb[6]
              + C2[3] * z * gb[7] + 2.0 * C2[4] * x * gb[8])
        gy = (gy + C2[0] * x * gb[4] + C2[1] * z * gb[5]
              - 2.0 * C2[2] * y * gb[6] - 2.0 * C2[4] * y * gb[8])
        gz = (gz + C2[1] * y * gb[5] + 4.0 * C2[2] * z * gb[6]
              + C2[3] * x * gb[7])
    if degree >= 3:
        gx = (gx + C3[0] * 6.0 * xy * gb[9] + C3[1] * yz * gb[10]
              - C3[2] * 2.0 * xy * gb[11] - C3[3] * 6.0 * xz * gb[12]
              + C3[4] * (4.0 * zz - 3.0 * xx - yy) * gb[13]
              + C3[5] * 2.0 * xz * gb[14]
              + C3[6] * 3.0 * (xx - yy) * gb[15])
        gy = (gy + C3[0] * 3.0 * (xx - yy) * gb[9] + C3[1] * xz * gb[10]
              + C3[2] * (4.0 * zz - xx - 3.0 * yy) * gb[11]
              - C3[3] * 6.0 * yz * gb[12] - C3[4] * 2.0 * xy * gb[13]
              - C3[5] * 2.0 * yz * gb[14] - C3[6] * 6.0 * xy * gb[15])
        gz = (gz + C3[1] * xy * gb[10] + C3[2] * 8.0 * yz * gb[11]
              + C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * gb[12]
              + C3[4] * 8.0 * xz * gb[13] + C3[5] * (xx - yy) * gb[14])
    if degree >= 4:
        z7m1, z7m3 = 7.0 * zz - 1.0, 7.0 * zz - 3.0
        gx = (gx + C4[0] * y * (3.0 * xx - yy) * gb[16]
              + C4[1] * 6.0 * xy * z * gb[17] + C4[2] * y * z7m1 * gb[18]
              + C4[5] * z * z7m3 * gb[21]
              + C4[6] * 2.0 * x * z7m1 * gb[22]
              + C4[7] * 3.0 * z * (xx - yy) * gb[23]
              + C4[8] * 4.0 * x * (xx - 3.0 * yy) * gb[24])
        gy = (gy + C4[0] * x * (xx - 3.0 * yy) * gb[16]
              + C4[1] * 3.0 * z * (xx - yy) * gb[17]
              + C4[2] * x * z7m1 * gb[18] + C4[3] * z * z7m3 * gb[19]
              - C4[6] * 2.0 * y * z7m1 * gb[22]
              - C4[7] * 6.0 * xy * z * gb[23]
              + C4[8] * 4.0 * y * (yy - 3.0 * xx) * gb[24])
        gz = (gz + C4[1] * y * (3.0 * xx - yy) * gb[17]
              + C4[2] * 14.0 * xy * z * gb[18]
              + C4[3] * y * (21.0 * zz - 3.0) * gb[19]
              + C4[4] * z * (140.0 * zz - 60.0) * gb[20]
              + C4[5] * x * (21.0 * zz - 3.0) * gb[21]
              + C4[6] * 14.0 * z * (xx - yy) * gb[22]
              + C4[7] * x * (xx - 3.0 * yy) * gb[23])
    return gx, gy, gz


def _eval_sh_components(degree: int, sh: torch.Tensor, x, y, z):
    """eval_sh on decomposed [N] direction components. Returns [N, 3]."""
    basis = _sh_basis(degree, x, y, z)
    n, k, _ = sh.shape
    sht = sh.reshape(n, k * 3).T                       # [3K, N]
    chans = []
    for c in range(3):
        acc = basis[0] * sht[c]
        for i in range(1, len(basis)):
            acc = acc + basis[i] * sht[3 * i + c]
        chans.append(acc)
    return torch.stack(chans, dim=-1)


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen-space quantities. All [N, ...]."""
    means2d: torch.Tensor   # [N, 2] pixel coordinates
    conic: torch.Tensor     # [N, 3] inverse 2D covariance (a, b, c) packed
    rgb: torch.Tensor       # [N, 3] view-dependent color (>= 0)
    opacity: torch.Tensor   # [N] activated opacity
    depth: torch.Tensor     # [N] camera-space z
    radius: torch.Tensor    # [N] int32 pixel radius (0 => culled)
    valid: torch.Tensor     # [N] bool visibility mask


def _geometry(means3d, scales, quats, camera: Camera, scale_modifier):
    """The per-row terms of the projection up to the 2D covariance's
    inverse, in the plain version's arithmetic and order. ``camera`` is
    on the rows' device."""
    view = camera.view
    w_rot = view[:3, :3]

    x3 = means3d[:, 0]
    y3 = means3d[:, 1]
    z3 = means3d[:, 2]

    def affine3(row):
        return row[0] * x3 + row[1] * y3 + row[2] * z3 + row[3]

    # --- view/clip transforms ---
    pvx = affine3(view[0])
    pvy = affine3(view[1])
    depth = affine3(view[2])

    fp = camera.full_proj
    hx = affine3(fp[0])
    hy = affine3(fp[1])
    hw = affine3(fp[3])
    inv_w = 1.0 / (hw + 1e-7)

    # --- EWA covariance projection ---
    q = transforms.normalize_quat(quats)
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0 = scale_modifier * scales[:, 0]
    s1 = scale_modifier * scales[:, 1]
    s2 = scale_modifier * scales[:, 2]
    # Sigma = (R S)(R S)^T with S = diag(s): L[i][k] = R[i][k] s_k.
    l00, l01, l02 = r00 * s0, r01 * s1, r02 * s2
    l10, l11, l12 = r10 * s0, r11 * s1, r12 * s2
    l20, l21, l22 = r20 * s0, r21 * s1, r22 * s2
    cxx = l00 * l00 + l01 * l01 + l02 * l02
    cxy = l00 * l10 + l01 * l11 + l02 * l12
    cxz = l00 * l20 + l01 * l21 + l02 * l22
    cyy = l10 * l10 + l11 * l11 + l12 * l12
    cyz = l10 * l20 + l11 * l21 + l12 * l22
    czz = l20 * l20 + l21 * l21 + l22 * l22

    fx = camera.focal_x
    fy = camera.focal_y
    limx = 1.3 * camera.tanfovx
    limy = 1.3 * camera.tanfovy
    z = depth
    tqx = pvx / z
    tqy = pvy / z
    tcx = torch.clamp(tqx, -limx, limx)
    tcy = torch.clamp(tqy, -limy, limy)
    tx = tcx * z
    ty = tcy * z

    # J is the 2x3 Jacobian of the perspective projection at (tx, ty, z).
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    # M = J @ W_rot : two [N]-component row vectors.
    m0x = j00 * w_rot[0, 0] + j02 * w_rot[2, 0]
    m0y = j00 * w_rot[0, 1] + j02 * w_rot[2, 1]
    m0z = j00 * w_rot[0, 2] + j02 * w_rot[2, 2]
    m1x = j11 * w_rot[1, 0] + j12 * w_rot[2, 0]
    m1y = j11 * w_rot[1, 1] + j12 * w_rot[2, 1]
    m1z = j11 * w_rot[1, 2] + j12 * w_rot[2, 2]
    # cov2d = M @ cov3d @ M^T (symmetric 2x2).
    cm0x = cxx * m0x + cxy * m0y + cxz * m0z
    cm0y = cxy * m0x + cyy * m0y + cyz * m0z
    cm0z = cxz * m0x + cyz * m0y + czz * m0z
    cm1x = cxx * m1x + cxy * m1y + cxz * m1z
    cm1y = cxy * m1x + cyy * m1y + cyz * m1z
    cm1z = cxz * m1x + cyz * m1y + czz * m1z
    cov_a = m0x * cm0x + m0y * cm0y + m0z * cm0z + COV2D_DILATION
    cov_b = m0x * cm1x + m0y * cm1y + m0z * cm1z
    cov_c = m1x * cm1x + m1y * cm1y + m1z * cm1z + COV2D_DILATION

    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det > 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det,
                                                    torch.ones_like(det)),
                          torch.zeros_like(det))
    return SimpleNamespace(
        x3=x3, y3=y3, z3=z3, pvx=pvx, pvy=pvy, depth=depth, hx=hx, hy=hy,
        inv_w=inv_w, q=q, r=((r00, r01, r02), (r10, r11, r12),
                             (r20, r21, r22)),
        s=(s0, s1, s2), l=((l00, l01, l02), (l10, l11, l12),
                           (l20, l21, l22)),
        sigma=((cxx, cxy, cxz), (cxy, cyy, cyz), (cxz, cyz, czz)),
        fx=fx, fy=fy, limx=limx, limy=limy, tqx=tqx, tqy=tqy, tcx=tcx,
        tcy=tcy, tx=tx, ty=ty, inv_z=inv_z, inv_z2=inv_z2, m0=(m0x, m0y, m0z),
        m1=(m1x, m1y, m1z), cm0=(cm0x, cm0y, cm0z), cm1=(cm1x, cm1y, cm1z),
        cov_a=cov_a, cov_b=cov_b, cov_c=cov_c, det=det, det_ok=det_ok,
        inv_det=inv_det)


def _view_dirs(g, camera: Camera):
    """(dx, dy, dz, |d|, 1 / max(|d|, 1e-12)): each row's offset from the
    camera centre, whose direction the SH colour is evaluated at."""
    c = camera.cam_center
    dx = g.x3 - c[0]
    dy = g.y3 - c[1]
    dz = g.z3 - c[2]
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    return dx, dy, dz, norm, 1.0 / norm.clamp_min(1e-12)


def project_plain(
    means3d: torch.Tensor,          # [N, 3]
    scales: torch.Tensor,           # [N, 3] activated (post-exp)
    quats: torch.Tensor,            # [N, 4] unnormalized (w, x, y, z)
    opacities: torch.Tensor,        # [N] activated
    shs: torch.Tensor,              # [N, K, 3]
    camera: Camera,
    sh_degree: int,
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,  # [N, 3] overrides SH
) -> ProjectedGaussians:
    """The projection in plain torch, differentiable by autograd."""
    camera = camera.to(means3d.device)
    g = _geometry(means3d, scales, quats, camera, scale_modifier)
    m2x = ((g.hx * g.inv_w + 1.0) * float(camera.width) - 1.0) * 0.5
    m2y = ((g.hy * g.inv_w + 1.0) * float(camera.height) - 1.0) * 0.5
    means2d = torch.stack([m2x, m2y], dim=-1)
    cov_a, cov_b, cov_c, det = g.cov_a, g.cov_b, g.cov_c, g.det
    conic = torch.stack([cov_c * g.inv_det, -cov_b * g.inv_det,
                         cov_a * g.inv_det], dim=-1)

    mid = 0.5 * (cov_a + cov_c)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    # --- color ---
    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        dx, dy, dz, _, inv_n = _view_dirs(g, camera)
        rgb = torch.clamp_min(
            _eval_sh_components(sh_degree, shs,
                                dx * inv_n, dy * inv_n, dz * inv_n) + 0.5,
            0.0)

    # Opacity cull is lossless: alpha = opac*exp(power) <= opac, and the
    # blend skips alpha < 1/255, so such rows contribute exactly zero.
    valid = ((g.depth > NEAR_CULL_Z) & g.det_ok & (radius_f > 0.0)
             & (opacities >= 1.0 / 255.0))
    radius = torch.where(valid, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)

    return ProjectedGaussians(
        means2d=means2d,
        conic=conic,
        rgb=rgb,
        opacity=opacities,
        depth=g.depth,
        radius=radius,
        valid=valid,
    )


def project_backward_plain(means3d, scales, quats, shs, camera: Camera,
                           sh_degree: int, scale_modifier, g_means2d,
                           g_conic, g_rgb, g_depth):
    """The projection's backward in closed form, as ``project_bwd``
    computes it: the gradients of ``means3d``, ``scales``, ``quats`` and
    ``shs`` (``None`` when ``shs`` is: colours given) from those of
    ``means2d``, ``conic``, ``rgb`` and ``depth`` (each may be ``None``:
    zero). The forward's terms are recomputed from the inputs."""
    camera = camera.to(means3d.device)
    g = _geometry(means3d, scales, quats, camera, scale_modifier)
    zero = torch.zeros_like(g.depth)

    def col(t, k):
        return zero if t is None else t[:, k]

    # means2d = ((h * inv_w + 1) * size - 1) / 2, inv_w = 1 / (hw + 1e-7)
    u = col(g_means2d, 0) * 0.5 * float(camera.width)
    v = col(g_means2d, 1) * 0.5 * float(camera.height)
    g_hx, g_hy = u * g.inv_w, v * g.inv_w
    g_hw = -(u * g.hx + v * g.hy) * (g.inv_w * g.inv_w)

    # conic = (c, -b, a) * inv_det; the det > 0 guard blocks the rest.
    gc0, gc1, gc2 = (col(g_conic, k) for k in range(3))
    g_inv_det = gc0 * g.cov_c - gc1 * g.cov_b + gc2 * g.cov_a
    g_det = torch.where(g.det_ok, -g_inv_det * (g.inv_det * g.inv_det),
                        zero)
    g_a = gc2 * g.inv_det + g_det * g.cov_c
    g_b = -gc1 * g.inv_det - 2.0 * g_det * g.cov_b
    g_c = gc0 * g.inv_det + g_det * g.cov_a

    # cov2d = M Sigma M^T, M's rows m0, m1, cm = Sigma m.
    m0, m1, cm0, cm1, sig = g.m0, g.m1, g.cm0, g.cm1, g.sigma
    g_cm0 = [g_a * m0[k] for k in range(3)]
    g_cm1 = [g_b * m0[k] + g_c * m1[k] for k in range(3)]
    g_m0 = [g_a * cm0[k] + g_b * cm1[k]
            + sum(sig[k][r] * g_cm0[r] for r in range(3)) for k in range(3)]
    g_m1 = [g_c * cm1[k] + sum(sig[k][r] * g_cm1[r] for r in range(3))
            for k in range(3)]
    # Sigma = L L^T; gs the gradient of its symmetric entries, both halves.
    gs = [[g_cm0[r] * m0[k] + g_cm1[r] * m1[k] + g_cm0[k] * m0[r]
           + g_cm1[k] * m1[r] for k in range(3)] for r in range(3)]
    g_l = [[sum(gs[r][k] * g.l[k][j] for k in range(3)) for j in range(3)]
           for r in range(3)]
    g_r = [[g_l[i][k] * g.s[k] for k in range(3)] for i in range(3)]
    g_s = [sum(g_l[i][k] * g.r[i][k] for i in range(3)) for k in range(3)]
    g_scales = torch.stack([gk * scale_modifier for gk in g_s], dim=-1)

    # R(q), q = quats / sqrt(|quats|^2 + eps)
    qw, qx, qy, qz = g.q[:, 0], g.q[:, 1], g.q[:, 2], g.q[:, 3]
    (g00, g01, g02), (g10, g11, g12), (g20, g21, g22) = g_r
    g_qw = 2.0 * (-qz * g01 + qy * g02 + qz * g10 - qx * g12 - qy * g20
                  + qx * g21)
    g_qx = 2.0 * (qy * g01 + qz * g02 + qy * g10 - 2.0 * qx * g11
                  - qw * g12 + qz * g20 + qw * g21 - 2.0 * qx * g22)
    g_qy = 2.0 * (-2.0 * qy * g00 + qx * g01 + qw * g02 + qx * g10
                  + qz * g12 - qw * g20 + qz * g21 - 2.0 * qy * g22)
    g_qz = 2.0 * (-2.0 * qz * g00 - qw * g01 + qx * g02 + qw * g10
                  - 2.0 * qz * g11 + qy * g12 + qx * g20 + qy * g21)
    g_q = torch.stack([g_qw, g_qx, g_qy, g_qz], dim=-1)
    norm = torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True) + 1e-12)
    g_quats = (g_q - g.q * torch.sum(g_q * g.q, dim=-1, keepdim=True)) / norm

    # M = J W_rot; J at (tx, ty, z) with t = clamp(pv / z, -lim, lim) z.
    w = camera.view
    g_j00 = sum(g_m0[k] * w[0, k] for k in range(3))
    g_j02 = sum(g_m0[k] * w[2, k] for k in range(3))
    g_j11 = sum(g_m1[k] * w[1, k] for k in range(3))
    g_j12 = sum(g_m1[k] * w[2, k] for k in range(3))
    g_tx = g_j02 * -g.fx * g.inv_z2
    g_ty = g_j12 * -g.fy * g.inv_z2
    g_iz2 = g_j02 * -g.fx * g.tx + g_j12 * -g.fy * g.ty
    g_iz = g_j00 * g.fx + g_j11 * g.fy + 2.0 * g.inv_z * g_iz2
    z = g.depth
    in_x = (g.tqx >= -g.limx) & (g.tqx <= g.limx)
    in_y = (g.tqy >= -g.limy) & (g.tqy <= g.limy)
    g_tqx = torch.where(in_x, g_tx * z, zero)
    g_tqy = torch.where(in_y, g_ty * z, zero)
    g_z = (-g_iz * (g.inv_z * g.inv_z) + g_tx * g.tcx + g_ty * g.tcy
           - (g_tqx * g.tqx + g_tqy * g.tqy) / z)
    g_pvx, g_pvy = g_tqx / z, g_tqy / z
    g_pz = (zero if g_depth is None else g_depth) + g_z

    fp = camera.full_proj
    g_means = [g_pvx * w[0, k] + g_pvy * w[1, k] + g_pz * w[2, k]
               + g_hx * fp[0, k] + g_hy * fp[1, k] + g_hw * fp[3, k]
               for k in range(3)]

    g_shs = None
    if shs is not None:
        g_shs = torch.zeros_like(shs)
        dx, dy, dz, nrm, inv_n = _view_dirs(g, camera)
        x, y, z = dx * inv_n, dy * inv_n, dz * inv_n
        basis = _sh_basis(sh_degree, x, y, z)
        nb = len(basis)
        raw = _eval_sh_components(sh_degree, shs, x, y, z) + 0.5
        g_acc = (torch.zeros_like(raw) if g_rgb is None
                 else torch.where(raw >= 0.0, g_rgb, torch.zeros_like(raw)))
        g_shs[:, 0] = basis[0] * g_acc
        for i in range(1, nb):
            g_shs[:, i] = basis[i][:, None] * g_acc
        gb = [None] + [torch.sum(shs[:, i] * g_acc, dim=-1)
                       for i in range(1, nb)]
        gdx, gdy, gdz = _sh_basis_grad(sh_degree, x, y, z, gb)
        # dir = d * inv_n, inv_n = 1 / max(|d|, 1e-12)
        g_inv_n = gdx * dx + gdy * dy + gdz * dz
        g_nrm = torch.where(nrm >= 1e-12, -g_inv_n * (inv_n * inv_n), zero)
        g_sq = g_nrm / (2.0 * nrm)
        for k, (gd, d) in enumerate(((gdx, dx), (gdy, dy), (gdz, dz))):
            g_means[k] = g_means[k] + gd * inv_n + 2.0 * d * g_sq
    return torch.stack(g_means, dim=-1), g_scales, g_quats, g_shs


# --- the CUDA kernel pair (csrc/project.cu) --------------------------------

def _row_stride(t: torch.Tensor, name: str, n: int, cols: int) -> int:
    """The row stride (elements) of a per-row input the kernels read:
    ``[n, cols]`` (``[n]`` for ``cols == 0``) float32 whose components
    are adjacent; the rows may lie at any stride."""
    shape = (n, cols) if cols else (n,)
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want float32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if cols > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: components must be adjacent, got "
                         f"strides {t.stride()}")
    return t.stride(0)


def _grad_rows(t: Optional[torch.Tensor], n: int, cols: int):
    """An incoming gradient as (pointer, row stride): a null pointer for
    ``None``, a contiguous copy only where its components are not
    adjacent."""
    if t is None:
        return None, 0, 0
    if cols > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t, t.data_ptr(), t.stride(0)


def _camera_args(camera: Camera, device):
    """The camera's five tensors on ``device`` as the kernels read them
    (contiguous float32: view [4,4], full_proj [4,4], centre [3], tangents
    [] [])."""
    camera = camera.to(device)
    out = []
    for name, shape in (("view", (4, 4)), ("full_proj", (4, 4)),
                        ("cam_center", (3,)), ("tanfovx", ()),
                        ("tanfovy", ())):
        t = getattr(camera, name)
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"camera.{name}: want float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        out.append(t.contiguous())
    return out


_COLUMNS = {"means3d": 3, "scales": 3, "quats": 4, "opacities": 0}


def _check_inputs(rows: dict, shs, sh_degree: int):
    """Check the per-row inputs (``rows``: name -> tensor, of
    ``_COLUMNS``) and ``shs`` (None when colours are given). Returns (N,
    the row strides in ``rows``' order then shs's, K)."""
    first = next(iter(rows.values()))
    n = first.shape[0] if first.dim() >= 1 else -1
    named = dict(rows, **({} if shs is None else {"shs": shs}))
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"projection kernel needs CUDA tensors on one "
                             f"device, {name} is on {t.device}")
    strides = [_row_stride(t, name, n, _COLUMNS[name])
               for name, t in rows.items()]
    if shs is None:
        return n, strides + [0], 0
    if not (0 <= sh_degree <= 4):
        raise ValueError(f"unsupported SH degree {sh_degree}")
    need = (sh_degree + 1) ** 2
    if (shs.dtype != torch.float32 or shs.dim() != 3 or shs.shape[0] != n
            or shs.shape[1] < need or shs.shape[2] != 3):
        raise ValueError(f"shs: want float32 [{n}, >= {need}, 3], got "
                         f"{shs.dtype} {tuple(shs.shape)}")
    if shs.stride(2) != 1 or shs.stride(1) != 3:
        raise ValueError(f"shs: each row's [K, 3] must be contiguous, got "
                         f"strides {shs.stride()}")
    return n, strides + [shs.stride(0)], shs.shape[1]


_FWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong] * 5
                 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                 + [ctypes.c_float] + [ctypes.c_void_p] * 7)
_BWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong] * 4
                 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                 + [ctypes.c_float] + [ctypes.c_void_p, ctypes.c_longlong] * 4
                 + [ctypes.c_void_p] * 5)


def _launch_fwd(means3d, scales, quats, opacities, shs, cam, width: int,
                height: int, degree: int, scale_modifier: float):
    """One ``project_fwd`` launch: (means2d [N,2], conic [N,3], rgb [N,3]
    or None when ``degree`` is -1 (colours given), depth [N], radius [N]
    int32, valid [N] bool), all contiguous."""
    n, strides, _ = _check_inputs(
        {"means3d": means3d, "scales": scales, "quats": quats,
         "opacities": opacities}, shs, degree)
    dev = means3d.device
    means2d = torch.empty((n, 2), dtype=torch.float32, device=dev)
    conic = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rgb = (torch.empty((n, 3), dtype=torch.float32, device=dev)
           if degree >= 0 else None)
    depth = torch.empty((n,), dtype=torch.float32, device=dev)
    radius = torch.empty((n,), dtype=torch.int32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return means2d, conic, rgb, depth, radius, valid
    fn = kernels.load("project").project_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = _FWD_ARGTYPES
    ins = (means3d, scales, quats, opacities, shs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(degree, n,
                    *[v for t, s in zip(ins, strides)
                      for v in (None if t is None else t.data_ptr(), s)],
                    *[t.data_ptr() for t in cam], width, height,
                    scale_modifier, means2d.data_ptr(), conic.data_ptr(),
                    None if rgb is None else rgb.data_ptr(),
                    depth.data_ptr(), radius.data_ptr(), valid.data_ptr(),
                    stream)
    kernels.check("project_fwd", status)
    kernels.LAUNCHES["project_fwd"] += 1
    return means2d, conic, rgb, depth, radius, valid


def _launch_bwd(means3d, scales, quats, shs, cam, width: int, height: int,
                degree: int, scale_modifier: float, g_means2d, g_conic,
                g_rgb, g_depth):
    """One ``project_bwd`` launch: the gradients of (means3d, scales,
    quats, shs), shs's None when ``degree`` is -1. Incoming gradients may
    be None (zero) or rows at any stride."""
    shs = shs if degree >= 0 else None
    n, strides, k = _check_inputs(
        {"means3d": means3d, "scales": scales, "quats": quats}, shs, degree)
    dev = means3d.device
    g_means = torch.empty((n, 3), dtype=torch.float32, device=dev)
    g_scales = torch.empty((n, 3), dtype=torch.float32, device=dev)
    g_quats = torch.empty((n, 4), dtype=torch.float32, device=dev)
    g_shs = (torch.empty((n, k, 3), dtype=torch.float32, device=dev)
             if degree >= 0 else None)
    if n == 0:
        return g_means, g_scales, g_quats, g_shs
    incoming = [_grad_rows(t, n, c) for t, c in
                ((g_means2d, 2), (g_conic, 3),
                 (g_rgb if shs is not None else None, 3), (g_depth, 0))]
    fn = kernels.load("project").project_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = _BWD_ARGTYPES
    ins = (means3d, scales, quats, shs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(degree, n,
                    *[v for t, s in zip(ins, strides)
                      for v in (None if t is None else t.data_ptr(), s)],
                    k, *[t.data_ptr() for t in cam], width, height,
                    scale_modifier,
                    *[v for _, p, s in incoming for v in (p, s)],
                    g_means.data_ptr(), g_scales.data_ptr(),
                    g_quats.data_ptr(),
                    None if g_shs is None else g_shs.data_ptr(), stream)
    kernels.check("project_bwd", status)
    kernels.LAUNCHES["project_bwd"] += 1
    return g_means, g_scales, g_quats, g_shs


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, shs, view, full_proj,
                center, tanx, tany, width, height, degree, scale_modifier):
        cam = (view, full_proj, center, tanx, tany)
        out = _launch_fwd(means3d, scales, quats, opacities, shs, cam, width,
                          height, degree, scale_modifier)
        ctx.save_for_backward(means3d, scales, quats, shs, *cam)
        ctx.args = (width, height, degree, scale_modifier)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out[4], out[5])
        return out

    @staticmethod
    def backward(ctx, g_means2d, g_conic, g_rgb, g_depth, _g_radius,
                 _g_valid):
        means3d, scales, quats, shs, *cam = ctx.saved_tensors
        grads = _launch_bwd(means3d, scales, quats, shs, cam, *ctx.args,
                            g_means2d, g_conic, g_rgb, g_depth)
        need = ctx.needs_input_grad
        g_means, g_scales, g_quats, g_shs = (
            g if need[i] else None for i, g in zip((0, 1, 2, 4), grads))
        return (g_means, g_scales, g_quats, None, g_shs) + (None,) * 9


def project_gaussians(
    means3d: torch.Tensor,          # [N, 3]
    scales: torch.Tensor,           # [N, 3] activated (post-exp)
    quats: torch.Tensor,            # [N, 4] unnormalized (w, x, y, z)
    opacities: torch.Tensor,        # [N] activated
    shs: torch.Tensor,              # [N, K, 3]
    camera: Camera,
    sh_degree: int,
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,  # [N, 3] overrides SH
) -> ProjectedGaussians:
    """Project Gaussians to the screen. CPU tensors run ``project_plain``;
    CUDA tensors launch ``project_fwd`` (and, under autograd,
    ``project_bwd`` in the backward) or raise. ``opacity`` is
    ``opacities`` itself and ``rgb`` is ``colors_precomp`` when given, so
    their gradients pass the kernels by. Per-row inputs may lie at any
    row stride with their components adjacent (``shs``: each row's
    ``[K, 3]`` contiguous)."""
    args = (means3d, scales, quats, opacities, shs)
    if all(t is None or t.device.type == "cpu" for t in args):
        return project_plain(means3d, scales, quats, opacities, shs, camera,
                             sh_degree, scale_modifier, colors_precomp)
    degree = -1 if colors_precomp is not None else int(sh_degree)
    sh_in = shs if degree >= 0 else None
    cam = _camera_args(camera, means3d.device)
    size = (int(camera.width), int(camera.height))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (means3d, scales, quats, sh_in)):
        out = _Project.apply(means3d, scales, quats, opacities, sh_in, *cam,
                             *size, degree, float(scale_modifier))
    else:
        out = _launch_fwd(means3d, scales, quats, opacities, sh_in, cam,
                          *size, degree, float(scale_modifier))
    means2d, conic, rgb, depth, radius, valid = out
    return ProjectedGaussians(
        means2d=means2d, conic=conic,
        rgb=colors_precomp if colors_precomp is not None else rgb,
        opacity=opacities, depth=depth, radius=radius, valid=valid)
