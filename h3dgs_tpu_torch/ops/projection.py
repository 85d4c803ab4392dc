"""Gaussian projection: 3D -> screen-space splats (torch).

Counterpart of ``h3dgs_tpu/ops/projection.py``: view/projection
transform, EWA covariance projection with low-pass dilation, conic +
radius, SH -> RGB. Same numerical conventions as the 3DGS-family CUDA
preprocess (tan-clamped Jacobian, +0.3 px dilation, radius =
ceil(3 sqrt(lambda_max)), z < 0.2 near cull, opacity cull at 1/255,
ndc2pix = ((ndc+1)*size-1)/2), written per component as the reference
writes it so the two agree to float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..scene.camera import Camera
from ..utils import sh as sh_utils
from ..utils import transforms

# Splats closer than this are culled.
NEAR_CULL_Z = 0.2
# Low-pass dilation added to the projected 2D covariance diagonal (pixels^2).
COV2D_DILATION = 0.3


def _eval_sh_components(degree: int, sh: torch.Tensor, x, y, z):
    """eval_sh on decomposed [N] direction components. Returns [N, 3]."""
    if not (0 <= degree <= 4):
        raise ValueError(f"unsupported SH degree {degree}")
    n, k, _ = sh.shape
    sht = sh.reshape(n, k * 3).T                       # [3K, N]

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
    camera = camera.to(means3d.device)
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
    m2x = ((hx * inv_w + 1.0) * float(camera.width) - 1.0) * 0.5
    m2y = ((hy * inv_w + 1.0) * float(camera.height) - 1.0) * 0.5
    means2d = torch.stack([m2x, m2y], dim=-1)

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
    tx = torch.clamp(pvx / z, -limx, limx) * z
    ty = torch.clamp(pvy / z, -limy, limy) * z

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
    conic = torch.stack([cov_c * inv_det, -cov_b * inv_det, cov_a * inv_det],
                        dim=-1)

    mid = 0.5 * (cov_a + cov_c)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    # --- color ---
    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        c = camera.cam_center
        dx = x3 - c[0]
        dy = y3 - c[1]
        dz = z3 - c[2]
        inv_n = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz).clamp_min(1e-12)
        rgb = torch.clamp_min(
            _eval_sh_components(sh_degree, shs,
                                dx * inv_n, dy * inv_n, dz * inv_n) + 0.5,
            0.0)

    # Opacity cull is lossless: alpha = opac*exp(power) <= opac, and the
    # blend skips alpha < 1/255, so such rows contribute exactly zero.
    valid = ((depth > NEAR_CULL_Z) & det_ok & (radius_f > 0.0)
             & (opacities >= 1.0 / 255.0))
    radius = torch.where(valid, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)

    return ProjectedGaussians(
        means2d=means2d,
        conic=conic,
        rgb=rgb,
        opacity=opacities,
        depth=depth,
        radius=radius,
        valid=valid,
    )
