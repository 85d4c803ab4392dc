"""Raw-tensor format for scenes past 8M points (counterpart of
``h3dgs_tpu/io/pt.py``).

The reference's ``save_pt`` / ``create_from_pt`` layout: six
``done_*.pt`` tensor dumps (``torch.save``) and a packed
``point_cloud.bin`` = int32 count | xyz f32 | cat(f_dc, f_rest) f32 |
opacity f32 | scaling f32 | rotation f32, the layout the SIBR tooling
reads. Both packages write the same ``point_cloud.bin`` bytes, and each
loads the other's ``done_*.pt`` files.
"""
from __future__ import annotations

import os
import struct
from typing import Dict

import torch

# file stem -> key of the arrays (read_gaussian_ply's names)
NAMES = dict(xyz="xyz", dc="features_dc", rest="features_rest",
             opacity="opacity", scaling="scaling", rotation="rotation")


def _cpu32(x) -> torch.Tensor:
    """A float32 CPU tensor with its own storage (``torch.save`` writes a
    view's whole storage)."""
    t = torch.as_tensor(x).detach().to("cpu", torch.float32)
    return t.clone(memory_format=torch.contiguous_format)


def save_pt(path: str, *, xyz, features_dc, features_rest, opacity,
            scaling, rotation) -> None:
    """Write the six ``done_*.pt`` dumps and ``point_cloud.bin`` into
    ``path``; the arrays are numpy arrays or tensors on any device."""
    os.makedirs(path, exist_ok=True)
    arrs = dict(xyz=xyz, dc=features_dc, rest=features_rest,
                opacity=opacity, scaling=scaling, rotation=rotation)
    arrs = {k: _cpu32(v) for k, v in arrs.items()}
    for name, t in arrs.items():
        torch.save(t, os.path.join(path, f"done_{name}.pt"))
    n = arrs["xyz"].shape[0]
    shs = torch.cat([arrs["dc"].reshape(n, -1, 3),
                     arrs["rest"].reshape(n, -1, 3)], dim=1)
    with open(os.path.join(path, "point_cloud.bin"), "wb") as f:
        f.write(struct.pack("i", int(n)))
        for t in (arrs["xyz"], shs, arrs["opacity"], arrs["scaling"],
                  arrs["rotation"]):
            f.write(t.numpy().tobytes())


def load_pt(path: str) -> Dict[str, torch.Tensor]:
    """Read the ``done_*.pt`` dumps -> dict of float32 CPU tensors under
    ``read_gaussian_ply``'s keys."""
    out = {}
    for short, key in NAMES.items():
        t = torch.load(os.path.join(path, f"done_{short}.pt"),
                       map_location="cpu", weights_only=True)
        out[key] = t.detach().to(torch.float32)
    return out
