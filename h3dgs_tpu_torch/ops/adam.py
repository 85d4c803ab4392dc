"""Masked sparse Adam (counterpart of ``h3dgs_tpu/ops/adam.py``).

The reference's OurAdam updates only the rows whose opacity gradient is
nonzero; rows not touched this step keep their moments undecayed, and one
step counter is shared by all parameter groups. The update is written as
``torch.where`` over whole tensors, as the JAX package writes it, and
returns new tensors (the caller swaps them in).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: torch.Tensor  # [] int32, shared across groups (OurAdam semantics)


def init(params: Dict[str, torch.Tensor]) -> AdamState:
    dev = next(iter(params.values())).device
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     step=torch.zeros((), dtype=torch.int32, device=dev))


def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def sparse_adam_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: AdamState,
    lrs: Dict[str, float],
    row_mask: torch.Tensor,        # [C] bool: rows to update this step
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-15,            # the reference's eps (the exposure
                                   # optimizer passes 1e-8)
):
    """One masked Adam step. Returns (new_params, new_state)."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(beta1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(beta2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    sqrt_bc2 = torch.sqrt(bc2)

    new_params, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = _rows(row_mask, p.dim())
        mu = torch.where(m, beta1 * state.mu[k] + (1.0 - beta1) * g,
                         state.mu[k])
        nu = torch.where(m, beta2 * state.nu[k] + (1.0 - beta2) * g * g,
                         state.nu[k])
        denom = torch.sqrt(nu) / sqrt_bc2 + eps
        lr = torch.as_tensor(lrs[k], dtype=torch.float32, device=p.device)
        upd = (lr / bc1) * mu / denom
        new_params[k] = torch.where(m, p - upd, p)
        new_mu[k] = mu
        new_nu[k] = nu
    return new_params, AdamState(mu=new_mu, nu=new_nu, step=step)


def reset_rows(state: AdamState, row_mask: torch.Tensor,
               keys=None) -> AdamState:
    """Zero optimizer moments for masked rows (slot reuse, opacity
    reset)."""
    keys = set(state.mu.keys() if keys is None else keys)
    mu = dict(state.mu)
    nu = dict(state.nu)
    for k in keys:
        m = _rows(row_mask, state.mu[k].dim())
        mu[k] = torch.where(m, torch.zeros_like(state.mu[k]), state.mu[k])
        nu[k] = torch.where(m, torch.zeros_like(state.nu[k]), state.nu[k])
    return dataclasses.replace(state, mu=mu, nu=nu)


def grow_rows(state: AdamState, new_capacity: int,
              tail_rows: int = 0) -> AdamState:
    """Grow per-row moments to a larger capacity (zeros for new rows).

    ``tail_rows`` > 0 keeps that many trailing rows (skybox_last layout)
    at the END of the new tensors, with the zero padding inserted before
    them, so moments stay row-aligned with ``model.state.grow_capacity``.
    The shared step counter is unchanged.
    """
    def grow(a):
        c = a.shape[0]
        if new_capacity <= c:
            raise ValueError(f"new capacity {new_capacity} <= current {c}")
        z = a.new_zeros((new_capacity,) + tuple(a.shape[1:]))
        body = c - tail_rows
        z[:body] = a[:body]
        if tail_rows:
            z[new_capacity - tail_rows:] = a[body:]
        return z

    return AdamState(mu={k: grow(v) for k, v in state.mu.items()},
                     nu={k: grow(v) for k, v in state.nu.items()},
                     step=state.step)

