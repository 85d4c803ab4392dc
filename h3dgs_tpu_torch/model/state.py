"""GaussianState: the parameter store rendering reads.

Counterpart of ``h3dgs_tpu/model/state.py`` for the serving path: the
parameter fields, the ``alive`` mask and the static layout metadata. The
densification statistics belong to the training slice and are not carried
yet. Rows keep the reference's layouts (hierarchy post mode: skybox rows
LAST, opacity activation |x|).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SH_REST = 15  # storage always holds degree-3 coefficients (1 + 15)

TENSOR_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity", "alive")


@dataclasses.dataclass
class GaussianState:
    """All tensors have leading dim = capacity C; dead rows are masked."""
    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, 15, 3]
    scaling: torch.Tensor        # [C, 3] log-scale
    rotation: torch.Tensor       # [C, 4] (w, x, y, z), unnormalized
    opacity: torch.Tensor        # [C, 1] pre-activation
    alive: torch.Tensor          # [C] bool

    max_sh_degree: int = 3
    opacity_abs: bool = False
    n_skybox: int = 0
    n_scaffold: int = 0
    skybox_last: bool = False

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def to(self, device) -> "GaussianState":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in TENSOR_FIELDS})

    def trainable_dict(self):
        """The six optimized tensors, keyed like the reference param groups."""
        return {
            "xyz": self.xyz,
            "f_dc": self.features_dc,
            "f_rest": self.features_rest,
            "opacity": self.opacity,
            "scaling": self.scaling,
            "rotation": self.rotation,
        }


def empty_state(capacity: int, max_sh_degree: int = 3, device=None,
                **static_kw) -> GaussianState:
    """Dead rows with the reference's padding defaults."""
    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    rotation = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
    rotation[:, 0] = 1.0
    return GaussianState(
        xyz=full((capacity, 3), 0.0),
        features_dc=full((capacity, 1, 3), 0.0),
        features_rest=full((capacity, SH_REST, 3), 0.0),
        scaling=full((capacity, 3), -10.0),
        rotation=rotation,
        opacity=full((capacity, 1), -10.0),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        max_sh_degree=max_sh_degree,
        **static_kw,
    )


def from_arrays(xyz, features_dc, features_rest, opacity, scaling, rotation,
                capacity: Optional[int] = None, max_sh_degree: int = 3,
                device=None, **static_kw) -> GaussianState:
    """Pack host arrays into a (padded) GaussianState on ``device``."""
    n = xyz.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    st = empty_state(capacity, max_sh_degree, device=device, **static_kw)
    rest = np.zeros((n, SH_REST, 3), np.float32)
    fr = np.asarray(features_rest, np.float32)
    rest[:, :fr.shape[1], :] = fr

    def f32(a, shape):
        return torch.as_tensor(np.asarray(a, np.float32).reshape(shape),
                               device=device)
    arrs = dict(
        xyz=f32(xyz, (n, 3)),
        features_dc=f32(features_dc, (n, 1, 3)),
        features_rest=f32(rest, (n, SH_REST, 3)),
        opacity=f32(opacity, (n, 1)),
        scaling=f32(scaling, (n, 3)),
        rotation=f32(rotation, (n, 4)))

    n_sky = int(static_kw.get("n_skybox", 0) or 0)
    sky_last = bool(static_kw.get("skybox_last", False))
    if sky_last and n_sky > 0 and capacity > n:
        # Every skybox_last consumer addresses the LAST rows of *capacity*:
        # with padding, physically place the trailing skybox rows there.
        body = n - n_sky
        for k, v in arrs.items():
            getattr(st, k)[:body] = v[:body]
            getattr(st, k)[capacity - n_sky:] = v[body:]
        st.alive[:body] = True
        st.alive[capacity - n_sky:] = True
    else:
        for k, v in arrs.items():
            getattr(st, k)[:n] = v
        st.alive[:n] = True
    return st


def state_from_jax_arrays(d: dict, device=None, **static) -> GaussianState:
    """The port's state from the JAX state's arrays.

    ``d`` maps the reference ``GaussianState`` field names to
    ``np.asarray`` of each field; ``static`` carries its static metadata
    (``max_sh_degree``, ``opacity_abs``, ``n_skybox``, ``n_scaffold``,
    ``skybox_last``). Rows are copied as they are, padding included, so
    both packages compute the same thing on them. Fields the port does not
    hold yet (the densification statistics) are not read.
    """
    missing = [k for k in TENSOR_FIELDS if k not in d]
    if missing:
        raise KeyError(f"state arrays lack fields {missing}")
    tensors = {}
    for k in TENSOR_FIELDS:
        a = np.asarray(d[k])
        a = a.astype(bool) if k == "alive" else a.astype(np.float32)
        tensors[k] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return GaussianState(**tensors, **static)
