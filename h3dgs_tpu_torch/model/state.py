"""GaussianState: the fixed-capacity parameter store (counterpart of
``h3dgs_tpu/model/state.py``).

Parameters live in tensors of a fixed capacity with an ``alive`` mask;
densify / clone / split / prune write into free slots (``model/densify.py``)
and capacity grows in buckets when a densify pass runs out of slots. Rows
keep the reference's layouts:
  * flat training (coarse / single): skybox rows FIRST, then scaffold rows,
    then scene Gaussians;
  * hierarchy post mode: skybox rows LAST, opacity activation |x|.

Because free slots are filled lowest first, the live rows stay below a
high-water mark (``GaussianState.high_water``) that moves only when
``alive`` does; the flat step runs on the rows below it
(``parallel/step.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.adam import AdamState

SH_REST = 15  # storage always holds degree-3 coefficients (1 + 15)

TENSOR_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity", "alive")
STAT_FIELDS = ("max_radii2d", "xyz_gradient_accum", "denom")
ALL_FIELDS = TENSOR_FIELDS + STAT_FIELDS

# The high-water mark is a whole number of blocks of ROW_GRAIN rows. Over
# such a prefix every row-wise op splits the rows into the same vector
# blocks as over the whole store (the CPU's vector kernels run a tail in
# scalar code, whose exp / sigmoid may round the last bit otherwise), and
# the rows above it start 16-byte aligned for the copy back.
ROW_GRAIN = 64


def high_water_mark(alive: torch.Tensor) -> int:
    """The rows up to the last live one, rounded up to ``ROW_GRAIN`` and
    at most the capacity: ``alive[mark:]`` is all false. One host read."""
    c = alive.shape[0]
    if c == 0:
        return 0
    rows = torch.arange(1, c + 1, dtype=torch.int32, device=alive.device)
    last = int(torch.where(alive, rows, 0).max())
    return min(c, -(-last // ROW_GRAIN) * ROW_GRAIN)


# alive -> (alive._version, mark), held weakly: a tensor's version counter
# moves with every in-place write to it or to a view of it, and a new
# tensor is a new key, so no writer of ``alive`` has to update this.
_MARKS = WeakIdKeyDictionary()


def _cached_mark(alive: torch.Tensor) -> int:
    version = alive._version
    hit = _MARKS.get(alive)
    if hit is not None and hit[0] == version:
        return hit[1]
    mark = high_water_mark(alive)
    _MARKS[alive] = (version, mark)
    return mark


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

    # Densification statistics (reference gaussian_model.py:58-60).
    max_radii2d: torch.Tensor         # [C] f32
    xyz_gradient_accum: torch.Tensor  # [C] f32, max screen-grad norm
    denom: torch.Tensor               # [C] f32

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

    @property
    def n_alive(self) -> torch.Tensor:
        return self.alive.sum()

    @property
    def high_water(self) -> int:
        """Host int: every live row lies below it (``high_water_mark``).
        Read from the card once after ``alive`` changes, then kept. With
        ``skybox_last`` it is the capacity: the skybox lock addresses the
        last rows of the store."""
        if self.skybox_last and self.n_skybox:
            return self.capacity
        return _cached_mark(self.alive)

    def prefix(self, rows: int) -> "GaussianState":
        """Views of the first ``rows`` rows of every field (capacity
        ``rows``); the store itself when ``rows`` is its capacity."""
        if rows == self.capacity:
            return self
        return dataclasses.replace(
            self, **{k: getattr(self, k)[:rows] for k in ALL_FIELDS})

    def to(self, device) -> "GaussianState":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in ALL_FIELDS})

    # --- activations (gaussian_model.py:29-44) ---
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        n = torch.sqrt(torch.sum(self.rotation ** 2, -1, keepdim=True)
                       + 1e-12)
        return self.rotation / n

    def get_opacity(self) -> torch.Tensor:
        raw = (torch.abs(self.opacity) if self.opacity_abs
               else torch.sigmoid(self.opacity))
        return torch.where(self.alive[:, None], raw, torch.zeros_like(raw))

    def get_features(self, degree: Optional[int] = None) -> torch.Tensor:
        """[C, K, 3] SH coefficients, K = (degree+1)^2 (all 16 when
        ``degree`` is None). The rest coefficients are cut before the
        concatenation, so low degrees do not copy all of them."""
        rest = self.features_rest
        if degree is not None:
            rest = rest[:, :(degree + 1) ** 2 - 1, :]
        return torch.cat([self.features_dc, rest], dim=1)

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

    def replace_trainable(self, d) -> "GaussianState":
        return dataclasses.replace(
            self, xyz=d["xyz"], features_dc=d["f_dc"],
            features_rest=d["f_rest"], opacity=d["opacity"],
            scaling=d["scaling"], rotation=d["rotation"])

    def locked_rows_mask(self) -> torch.Tensor:
        """[C] bool: rows whose gradients are zeroed (the skybox lock:
        leading rows in flat training, trailing rows with skybox_last)."""
        idx = torch.arange(self.capacity, device=self.device)
        if self.n_skybox <= 0:
            return torch.zeros(self.capacity, dtype=torch.bool,
                               device=self.device)
        if self.skybox_last:
            return idx >= self.capacity - self.n_skybox
        return idx < self.n_skybox


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
        max_radii2d=full((capacity,), 0.0),
        xyz_gradient_accum=full((capacity,), 0.0),
        denom=full((capacity,), 0.0),
        max_sh_degree=max_sh_degree,
        **static_kw,
    )


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Re-allocate to a larger capacity, preserving all rows.

    Padding rows get ``empty_state``'s defaults (dead, degenerate scale).
    With skybox_last the padding goes before the trailing skybox block, so
    every other row index is kept (``ops/adam.grow_rows`` with the same
    tail keeps the moments aligned).
    """
    c = state.capacity
    if new_capacity <= c:
        raise ValueError(f"new capacity {new_capacity} <= current {c}")
    grown = empty_state(new_capacity, state.max_sh_degree,
                        device=state.device, opacity_abs=state.opacity_abs,
                        n_skybox=state.n_skybox, n_scaffold=state.n_scaffold,
                        skybox_last=state.skybox_last)
    body = (c - state.n_skybox if state.skybox_last and state.n_skybox
            else c)
    for k in ALL_FIELDS:
        old = getattr(state, k)
        new = getattr(grown, k)
        new[:body] = old[:body]
        if body < c:
            new[new_capacity - state.n_skybox:] = old[body:]
    return grown


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


def default_opacity_init(n: int, value: float = 0.01) -> np.ndarray:
    """Pre-activation opacity for fresh points (gaussian_model.py:199-202)."""
    v = np.full((n, 1), value, np.float32)
    return np.log(v / (np.float32(1.0) - v))


def state_from_jax_arrays(d: dict, device=None, **static) -> GaussianState:
    """The port's state from the JAX state's arrays.

    ``d`` maps the reference ``GaussianState`` field names to
    ``np.asarray`` of each field; ``static`` carries its static metadata
    (``max_sh_degree``, ``opacity_abs``, ``n_skybox``, ``n_scaffold``,
    ``skybox_last``). Rows are copied as they are, padding included. The
    densification statistics are read when present and start at zero
    otherwise.
    """
    missing = [k for k in TENSOR_FIELDS if k not in d]
    if missing:
        raise KeyError(f"state arrays lack fields {missing}")
    tensors = {}
    cap = np.asarray(d["xyz"]).shape[0]
    for k in ALL_FIELDS:
        if k not in d:
            tensors[k] = torch.zeros((cap,), dtype=torch.float32,
                                     device=device)
            continue
        a = np.asarray(d[k])
        a = a.astype(bool) if k == "alive" else a.astype(np.float32)
        tensors[k] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return GaussianState(**tensors, **static)


def adam_from_jax_arrays(mu: dict, nu: dict, step, device=None) -> AdamState:
    """The port's optimizer state from the JAX AdamState's arrays
    (``np.asarray`` of each moment, keyed by group, and of the step), so
    that state, optimizer and exposure all carry across."""
    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return AdamState(mu={k: t(v) for k, v in mu.items()},
                     nu={k: t(v) for k, v in nu.items()},
                     step=torch.as_tensor(np.array(step, np.int32),
                                          device=device))
