"""In-job checkpoints: full optimizer-state snapshots (counterpart of
``h3dgs_tpu/train/checkpoint.py``).

All six parameter tensors, the alive mask, the densification statistics,
the Adam moments and step, the exposure state and the iteration go into
one ``.npz`` under the reference's key names and shapes (``state.<field>``,
``opt.mu.<group>``, ``opt.nu.<group>``, ``opt.step``, ``exposure``,
``exp_opt.mu``, ``exp_opt.nu``, ``exp_opt.step``, ``iteration``), so a
checkpoint written by one package loads in the other. Tensors cross
through numpy on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..model.state import ALL_FIELDS, GaussianState
from ..ops.adam import AdamState


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_flat(path: str, state: GaussianState, opt: AdamState, exposure,
              exp_opt: AdamState, iteration: int) -> None:
    arrs = {f"state.{k}": _np(getattr(state, k)) for k in ALL_FIELDS}
    for k, v in opt.mu.items():
        arrs[f"opt.mu.{k}"] = _np(v)
    for k, v in opt.nu.items():
        arrs[f"opt.nu.{k}"] = _np(v)
    arrs["opt.step"] = _np(opt.step)
    arrs["exposure"] = _np(exposure)
    arrs["exp_opt.mu"] = _np(exp_opt.mu["exposure"])
    arrs["exp_opt.nu"] = _np(exp_opt.nu["exposure"])
    arrs["exp_opt.step"] = _np(exp_opt.step)
    arrs["iteration"] = np.asarray(iteration)
    np.savez(path, **arrs)


def load_flat(path: str, template: GaussianState):
    """Returns (state, opt, exposure, exp_opt, iteration) on the
    template's device. ``template`` supplies the static metadata (skybox
    counts, row layout, activation)."""
    dev = template.device

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    with np.load(path) as z:
        state = dataclasses.replace(
            template, **{k: t(z[f"state.{k}"],
                              torch.bool if k == "alive" else torch.float32)
                         for k in ALL_FIELDS})
        keys = [k.split(".", 2)[2] for k in z.files
                if k.startswith("opt.mu.")]
        opt = AdamState(
            mu={k: t(z[f"opt.mu.{k}"], torch.float32) for k in keys},
            nu={k: t(z[f"opt.nu.{k}"], torch.float32) for k in keys},
            step=t(z["opt.step"], torch.int32))
        exp_opt = AdamState(
            mu={"exposure": t(z["exp_opt.mu"], torch.float32)},
            nu={"exposure": t(z["exp_opt.nu"], torch.float32)},
            step=t(z["exp_opt.step"], torch.int32))
        return (state, opt, t(z["exposure"], torch.float32), exp_opt,
                int(z["iteration"]))
