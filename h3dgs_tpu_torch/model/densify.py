"""Densification (clone / split / prune) under fixed capacity (counterpart
of ``h3dgs_tpu/model/densify.py``).

Reference behaviour (gaussian_model.py:620-689):
  * stats: per-Gaussian running max of the screen-space positional
    gradient norm, times max 2D radius, times opacity^(1/5), thresholded;
    opacity must exceed 0.15; scaffold rows never densify;
  * clone if max scale <= percent_dense * extent (copy in place);
  * split if larger: N=2 children sampled from the Gaussian, scales
    divided by 0.8*N, original removed;
  * prune Gaussians with opacity < min_opacity (scaffold exempt);
  * all densification stats and max radii reset afterwards.

New rows go to free slots found by a stable argsort of ``alive`` (dead
slots first); what does not fit is counted and dropped, and a split is
all-or-nothing. The caller zeroes the Adam moments of touched rows.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..utils.transforms import inverse_sigmoid, quat_to_rotmat
from .state import GaussianState


class DensifyResult(NamedTuple):
    state: GaussianState
    touched_rows: torch.Tensor  # [C] bool: rows whose optimizer state resets
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor     # items that did not fit in capacity


def add_densification_stats(state: GaussianState, screen_grad: torch.Tensor,
                            radii: torch.Tensor,
                            visible: torch.Tensor) -> GaussianState:
    """Accumulate per-view stats. screen_grad: [C, 2] gradient of the loss
    with respect to the screen-space means; radii: [C] int32; visible: [C]
    bool."""
    norm = torch.linalg.vector_norm(screen_grad[:, :2], dim=-1)
    return dataclasses.replace(
        state,
        xyz_gradient_accum=torch.where(
            visible, torch.maximum(state.xyz_gradient_accum, norm),
            state.xyz_gradient_accum),
        denom=state.denom + visible.to(state.denom.dtype),
        max_radii2d=torch.where(
            visible, torch.maximum(state.max_radii2d,
                                   radii.to(torch.float32)),
            state.max_radii2d),
    )


def _protected_rows(state: GaussianState) -> torch.Tensor:
    """Rows exempt from densify / prune / shrink: the scaffold prefix
    (which includes the skybox)."""
    idx = torch.arange(state.capacity, device=state.device)
    return idx < max(state.n_scaffold, state.n_skybox)


def densify_and_prune(state: GaussianState, generator: torch.Generator,
                      max_grad: float, min_opacity: float, extent: float,
                      percent_dense: float, n_split: int = 2,
                      eps: Optional[torch.Tensor] = None) -> DensifyResult:
    """One densify + prune pass. ``eps`` [n_split, C, 3]: the split
    children's standard-normal offsets; drawn from ``generator`` when not
    given (tests pass the JAX sample)."""
    c = state.capacity
    dev = state.device
    opac = state.get_opacity()[:, 0]
    max_scale = torch.amax(state.get_scaling(), dim=1)
    protected = _protected_rows(state)
    extent = float(extent)

    score = state.xyz_gradient_accum * state.max_radii2d * opac ** 0.2
    base = (score >= max_grad) & (opac > 0.15) & state.alive & ~protected
    clone_sel = base & (max_scale <= percent_dense * extent)
    split_sel = base & (max_scale > percent_dense * extent)

    # --- destination slots from the free list ---
    free_list = torch.argsort(state.alive.to(torch.int8), stable=True)
    n_free = c - state.alive.sum()

    n_clones = clone_sel.sum()
    clone_rank = torch.cumsum(clone_sel.to(torch.int64), 0) - 1
    split_rank = torch.cumsum(split_sel.to(torch.int64), 0) - 1

    def dest_of(rank, sel):
        ok = sel & (rank < n_free)
        slot = free_list[rank.clamp(0, c - 1)]
        return torch.where(ok, slot, torch.full_like(slot, c)), ok

    clone_dest, clone_ok = dest_of(clone_rank, clone_sel)
    split_dest, split_ok = [], []
    for j in range(n_split):
        d, ok = dest_of(n_clones + n_split * split_rank + j, split_sel)
        split_dest.append(d)
        split_ok.append(ok)
    # All-or-nothing splits: ranks grow with j, so the last child fitting
    # means every child fits.
    split_all = split_ok[-1] if split_ok else clone_sel & False
    split_dest = [torch.where(split_all, d, torch.full_like(d, c))
                  for d in split_dest]

    # --- new rows ---
    rot = quat_to_rotmat(state.rotation)                          # [C,3,3]
    scales = state.get_scaling()
    if eps is None:
        eps = torch.randn((n_split, c, 3), generator=generator,
                          device=dev, dtype=scales.dtype)
    child_scaling = state.scaling - torch.log(
        torch.tensor(0.8 * n_split, dtype=torch.float32, device=dev))

    def scatter_rows(arr, dest, src_vals):
        keep = dest < c
        out = arr.clone()
        out[dest[keep]] = src_vals[keep]
        return out

    src = state.trainable_dict()
    new = dict(src)
    alive = state.alive.clone()
    for k in new:
        new[k] = scatter_rows(new[k], clone_dest, src[k])
    alive[clone_dest[clone_dest < c]] = True
    for j in range(n_split):
        # rot @ (eps * scales) per row, as elementwise products and sums
        # (float32, no matmul precision setting involved).
        offs = (rot * (eps[j] * scales)[:, None, :]).sum(dim=-1)
        vals = dict(src)
        vals["xyz"] = state.xyz + offs
        vals["scaling"] = child_scaling
        for k in new:
            new[k] = scatter_rows(new[k], split_dest[j], vals[k])
        alive[split_dest[j][split_dest[j] < c]] = True

    # --- kill split originals and low-opacity rows ---
    prune_sel = (opac < min_opacity) & state.alive & ~protected
    alive = alive & ~split_all & ~prune_sel

    touched = torch.zeros(c, dtype=torch.bool, device=dev)
    touched[clone_dest[clone_dest < c]] = True
    for j in range(n_split):
        touched[split_dest[j][split_dest[j] < c]] = True
    touched = touched | split_all | prune_sel

    zeros = torch.zeros(c, dtype=torch.float32, device=dev)
    out = dataclasses.replace(
        state.replace_trainable(new), alive=alive,
        xyz_gradient_accum=zeros, denom=zeros.clone(),
        max_radii2d=zeros.clone())
    n_cloned = clone_ok.sum()
    n_dropped = (clone_sel.sum() - n_cloned
                 + n_split * (split_sel & ~split_all).sum())
    return DensifyResult(state=out, touched_rows=touched, n_cloned=n_cloned,
                         n_split=split_all.sum(), n_pruned=prune_sel.sum(),
                         n_dropped=n_dropped)


def reset_opacity(state: GaussianState) -> GaussianState:
    """Clamp opacity to <= 0.01, keeping skybox rows and dead rows
    (gaussian_model.py:510-514). The caller zeroes the 'opacity' moments."""
    new_op = inverse_sigmoid(
        torch.clamp_min(torch.clamp_max(state.get_opacity(), 0.01), 1e-7))
    idx = torch.arange(state.capacity, device=state.device)[:, None]
    keep_old = ((idx >= state.capacity - state.n_skybox)
                if state.skybox_last else (idx < state.n_skybox))
    return dataclasses.replace(
        state, opacity=torch.where(keep_old | ~state.alive[:, None],
                                   state.opacity, new_op))


def shrink_big_gaussians(state: GaussianState, extent: float,
                         threshold_frac: float, factor: float = 0.8,
                         protect_scaffold: bool = True) -> GaussianState:
    """Every-iteration clamp of oversized Gaussians (train_single: 0.02 x
    extent, scaffold exempt; train_coarse: 0.1 x extent)."""
    max_scale = torch.amax(state.get_scaling(), dim=1)
    violators = (max_scale > threshold_frac * float(extent)) & state.alive
    if protect_scaffold:
        violators = violators & ~_protected_rows(state)
    new_scaling = state.scaling + torch.log(
        torch.tensor(factor, dtype=torch.float32, device=state.device))
    return dataclasses.replace(
        state, scaling=torch.where(violators[:, None], new_scaling,
                                   state.scaling))
