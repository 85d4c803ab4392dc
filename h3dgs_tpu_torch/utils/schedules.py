"""Learning-rate schedules (counterpart of ``h3dgs_tpu/utils/schedules.py``).

``expon_lr`` is the JaxNeRF/Plenoxels log-linear decay with optional
sinusoidal delay that the reference uses for the xyz and exposure learning
rates. The step is a host number, so the rates are Python floats computed
in float32 as the reference computes them.
"""
from __future__ import annotations

import numpy as np


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    if lr_init == 0.0:
        return 0.0
    step = np.float32(step)
    if lr_delay_steps > 0:
        delay_rate = np.float32(lr_delay_mult) + np.float32(
            1.0 - lr_delay_mult) * np.sin(
            np.float32(0.5 * np.pi)
            * np.clip(step / np.float32(lr_delay_steps), 0.0, 1.0),
            dtype=np.float32)
    else:
        delay_rate = np.float32(1.0)
    t = np.clip(step / np.float32(max_steps), 0.0, 1.0).astype(np.float32)
    log_lerp = np.exp(np.log(np.float32(lr_init)) * (np.float32(1.0) - t)
                      + np.log(np.float32(lr_final)) * t, dtype=np.float32)
    return 0.0 if step < 0 else float(np.float32(delay_rate * log_lerp))


def gaussian_lr_dict(opt_cfg, iteration, freeze_xyz: bool = False):
    """Per-parameter-group learning rates for Gaussian optimization: the
    exponential xyz schedule (zero when the coarse trainer freezes
    positions) and constant rates for features (f_rest at feature_lr/20),
    opacity, scaling and rotation."""
    xyz_lr = expon_lr(
        iteration, opt_cfg.position_lr_init, opt_cfg.position_lr_final,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps)
    if freeze_xyz:
        xyz_lr = 0.0
    return {
        "xyz": xyz_lr,
        "f_dc": opt_cfg.feature_lr,
        "f_rest": opt_cfg.feature_lr / 20.0,
        "opacity": opt_cfg.opacity_lr,
        "scaling": opt_cfg.scaling_lr,
        "rotation": opt_cfg.rotation_lr,
    }
