"""Seeded scene inputs, made on the device in a few large calls.

The scene is a textured height field ``y = surface(x, z)`` (world "up" is
-y, as in the port's synthetic scenes): one chunk covers x, z in
[-half, half] around its centre. From it come

- ``surface_gaussians``: Gaussians on the surface, coloured by the
  texture, as a chunk holds them partway through training;
- ``raycast_views``: the views' pixels and inverse depths, by casting
  each pixel's ray onto the height field (no renderer of the program is
  involved);
- ``build_hierarchy``: a balanced binary tree over the Gaussians in
  Morton order, interior nodes by moment matching (``hierarchy.py``).

Every draw comes from one ``torch.Generator`` seeded with ``--seed``; every
seed gets the same sizes.
"""
from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
WAVE_AMP = 0.4
SKY_RGB = (0.7, 0.8, 0.95)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g


def texture_phases(gen: torch.Generator, device) -> torch.Tensor:
    """[3, 4] per-channel phases of the texture, drawn from the seed."""
    return torch.rand((3, 4), generator=gen, device=device) * (2 * math.pi)


def surface(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return WAVE_AMP * torch.sin(x * 2.1) * torch.cos(z * 1.7)


def texture(x: torch.Tensor, z: torch.Tensor,
            phases: torch.Tensor) -> torch.Tensor:
    """[..., 3] colour in [0.1, 0.9] at surface points (x, z)."""
    chans = []
    for c in range(3):
        p = phases[c]
        v = (0.5 + 0.2 * torch.sin(3.1 * x + p[0]) * torch.sin(2.7 * z + p[1])
             + 0.12 * torch.sin(11.0 * x + p[2]) * torch.cos(9.0 * z + p[3])
             + 0.06 * torch.sin(37.0 * x + 29.0 * z + p[0]))
        chans.append(v)
    return torch.stack(chans, dim=-1).clamp(0.1, 0.9)


def random_quats(n: int, gen, device) -> torch.Tensor:
    q = torch.randn((n, 4), generator=gen, device=device)
    return q / q.norm(dim=1, keepdim=True)


def surface_gaussians(n: int, centre_x: float, half: float, phases,
                      gen, device, color_noise: float, pos_noise: float,
                      rest_std: float):
    """``n`` Gaussians on the chunk's surface. Returns a dict of float32
    tensors: xyz [n,3], rgb [n,3] (the texture under each), sh [n,16,3],
    log scales [n,3], unit quaternions [n,4], activated opacity [n]."""
    uv = (torch.rand((n, 2), generator=gen, device=device) * 2 - 1) * half
    x = uv[:, 0] + centre_x
    z = uv[:, 1]
    y = surface(x, z) + pos_noise * torch.randn(n, generator=gen,
                                                device=device)
    xyz = torch.stack([x, y, z], dim=1)
    rgb = texture(x, z, phases)
    sh = torch.randn((n, 16, 3), generator=gen, device=device) * rest_std
    noisy = rgb + color_noise * torch.randn((n, 3), generator=gen,
                                            device=device)
    sh[:, 0] = (noisy - 0.5) / SH_C0
    lo, hi = math.log(0.004), math.log(0.009)
    scaling = lo + (hi - lo) * torch.rand((n, 3), generator=gen,
                                          device=device)
    opacity = 0.3 + 0.65 * torch.rand(n, generator=gen, device=device)
    return {"xyz": xyz, "rgb": rgb, "sh": sh, "scaling": scaling,
            "rotation": random_quats(n, gen, device), "opacity": opacity}


def _rays(cam, device):
    """World-space ray directions [H*W, 3] (float64) of a camera."""
    w, h = cam["width"], cam["height"]
    rows = torch.tensor(cam["rows"], dtype=torch.float32, device=device)
    xs = ((torch.arange(w, device=device, dtype=torch.float32) + 0.5)
          / w * 2 - 1) * cam["tanfovx"]
    ys = ((torch.arange(h, device=device, dtype=torch.float32) + 0.5)
          / h * 2 - 1) * cam["tanfovy"]
    dc = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                      torch.ones((h, w), dtype=torch.float32,
                                 device=device)], dim=-1)
    return (dc @ rows).reshape(-1, 3)


def raycast_views(cams, phases, half: float, centres_x, device,
                  t_max: float = 16.0, dt: float = 0.05, group: int = 10):
    """Pixels and inverse depths of the height field seen by each camera.

    ``cams``: dicts with ``rows`` (world->camera rotation), ``eye``,
    ``tanfovx``, ``tanfovy``, ``width``, ``height`` (one size for all). A
    ray that meets the surface inside a chunk ([c - half, c + half] x
    [-half, half] for c in ``centres_x``) takes the texture there and
    inverse depth 1 / z_camera; any other ray sees the sky (inverse depth
    0). Rays are marched in steps of ``dt`` to the first crossing, then
    bisected, ``group`` views at a time.
    Returns (rgb uint8 [V,H,W,3], inverse depth float32 [V,H,W]).
    """
    h, w = cams[0]["height"], cams[0]["width"]
    imgs, invds = [], []
    sky = torch.tensor(SKY_RGB, device=device)
    for g0 in range(0, len(cams), group):
        part = cams[g0:g0 + group]
        d = torch.cat([_rays(c, device) for c in part])
        o = torch.cat([torch.tensor(c["eye"], dtype=torch.float32,
                                    device=device).expand(h * w, 3)
                       for c in part])
        fwd = torch.cat([torch.tensor(c["rows"][2], dtype=torch.float32,
                                      device=device).expand(h * w, 3)
                         for c in part])

        def g(t):
            p = o + t[:, None] * d
            return p[:, 1] - surface(p[:, 0], p[:, 2])

        n = d.shape[0]
        t_lo = torch.full((n,), 0.05, dtype=torch.float32, device=device)
        t_hi = torch.full((n,), t_max, dtype=torch.float32, device=device)
        found = torch.zeros(n, dtype=torch.bool, device=device)
        g_prev = g(t_lo)
        for k in range(1, int((t_max - 0.05) / dt) + 1):
            t = torch.full((n,), 0.05 + k * dt, dtype=torch.float32,
                           device=device)
            gk = g(t)
            hit = (~found) & (g_prev < 0) & (gk >= 0)
            t_hi = torch.where(hit, t, t_hi)
            t_lo = torch.where(hit, t - dt, t_lo)
            found |= hit
            g_prev = gk
        for _ in range(30):
            mid = 0.5 * (t_lo + t_hi)
            above = g(mid) < 0
            t_lo = torch.where(above, mid, t_lo)
            t_hi = torch.where(above, t_hi, mid)
        p = o + t_hi[:, None] * d
        inside = torch.zeros(n, dtype=torch.bool, device=device)
        for c in centres_x:
            inside |= ((p[:, 0] - c).abs() <= half) & (p[:, 2].abs() <= half)
        hit = found & inside
        col = texture(p[:, 0].float(), p[:, 2].float(), phases)
        col = torch.where(hit[:, None], col, sky[None, :])
        z_cam = ((p - o) * fwd).sum(-1).float()
        invd = torch.where(hit, 1.0 / z_cam, torch.zeros_like(z_cam))
        imgs.append((col * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
                    .reshape(len(part), h, w, 3))
        invds.append(invd.reshape(len(part), h, w))
    return torch.cat(imgs), torch.cat(invds)
