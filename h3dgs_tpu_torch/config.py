"""Configuration dataclasses (counterpart of ``h3dgs_tpu/config.py``).

``ModelConfig``, ``PipelineConfig`` and ``OptimizationConfig`` are copies
with every default: those defaults mirror the reference's CLI param groups
and are a behavioural spec. CLI entry points generate argparse flags from
these dataclasses (``cli/common.py``) under the reference's flag names.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelConfig:
    """Reference ModelParams (arguments/__init__.py:47-73)."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    exp_name: str = ""
    images: str = "images"
    alpha_masks: str = ""
    depths: str = ""
    resolution: int = -1
    white_background: bool = False
    train_test_exp: bool = False
    eval: bool = False
    skip_scale_big_gauss: bool = False
    hierarchy: str = ""
    pretrained: str = ""
    skybox_num: int = 0
    scaffold_file: str = ""
    bounds_file: str = ""
    skybox_locked: bool = False


@dataclasses.dataclass
class PipelineConfig:
    """Reference PipelineParams (arguments/__init__.py:75-80)."""
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass
class OptimizationConfig:
    """Reference OptimizationParams (arguments/__init__.py:82-106)."""
    iterations: int = 30_000
    position_lr_init: float = 0.00002
    position_lr_final: float = 0.0000002
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    exposure_lr_init: float = 0.001
    exposure_lr_final: float = 0.0001
    exposure_lr_delay_steps: int = 5000
    exposure_lr_delay_mult: float = 0.001
    percent_dense: float = 0.0001
    lambda_dssim: float = 0.2
    densification_interval: int = 300
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.015
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01


@dataclasses.dataclass
class RuntimeConfig:
    """Build knobs with no reference counterpart.

    Only the fields that mean something on the card carry over. The JAX
    package's entry-budget, quantum, Pallas-layout and truncation fields
    (``max_entries``, ``max_per_tile``, ``blend_chunk``, ``chunk_e``,
    ``quantum``, ``adaptive_entries``, ``bwd_entries``, ``prefix_mode``,
    ``bwd_chunk_e``, ``scatter_k``, ``binning_fill``, ``tafter_mode``,
    ``sort_mode``, ``gen_entries``, ``trunc_theta``, ``trunc_c``) size and
    lay out the TPU's static buffers. The port allocates exact entry counts
    and never truncates, so they have no counterpart in the port.
    """
    # Rasterizer tile side (the kernels are built for 16).
    tile: int = 16
    # Model capacity: fixed Gaussian slot count (densify headroom factor
    # applied to the initial point count when capacity == 0).
    capacity: int = 0
    capacity_factor: float = 8.0
    # Grow capacity (bucketed re-alloc + optimizer-moment copy) when a
    # densify pass drops clones/splits for lack of free slots; False keeps
    # the fixed budget and only warns.
    grow_capacity: bool = True
    # Upper bound for capacity growth (0 = unlimited).
    max_capacity: int = 0
    # In-step view data parallelism: the processes of the
    # torch.distributed group (one card each) that share each step's views
    # (parallel/step.make_dp_train_step); 1 = one process.
    data_devices: int = 1
    # Views per optimizer step in the data-parallel path (a multiple of
    # data_devices); 0 = one view per device.
    views_per_step: int = 0


@dataclasses.dataclass
class FullConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    pipe: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    opt: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
