"""CLI plumbing: dataclass configs -> argparse (reference flag names).

The reference generates argparse flags by reflection over ParamGroup
attributes (the reference's arguments/__init__.py:19-45) with shorthands
for a few (source_path -s, model_path -m, images -i, resolution -r). We do
the same over the config dataclasses so every reference knob exists under
the same name. The port's own copy of ``h3dgs_tpu/cli/common.py``, over the
port's dataclasses.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from ..config import (FullConfig, ModelConfig, OptimizationConfig,
                      PipelineConfig, RuntimeConfig)

_SHORTHANDS = {"source_path": "s", "model_path": "m", "images": "i",
               "resolution": "r"}


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix="") -> None:
    for f in dataclasses.fields(cls):
        name = f.name
        default = f.default if f.default is not dataclasses.MISSING \
            else f.default_factory()
        flags = [f"--{name}"]
        if name in _SHORTHANDS:
            flags.append(f"-{_SHORTHANDS[name]}")
        if isinstance(default, bool):
            # BooleanOptionalAction adds --name / --no-name so bools that
            # default True can actually be disabled from the CLI.
            parser.add_argument(*flags,
                                action=argparse.BooleanOptionalAction,
                                default=default)
        else:
            parser.add_argument(*flags, type=type(default), default=default)


def extract_dataclass(args: argparse.Namespace, cls):
    return cls(**{f.name: getattr(args, f.name)
                  for f in dataclasses.fields(cls)})


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    add_dataclass_args(p, ModelConfig)
    add_dataclass_args(p, OptimizationConfig)
    add_dataclass_args(p, PipelineConfig)
    add_dataclass_args(p, RuntimeConfig)
    return p


def add_train_args(parser: argparse.ArgumentParser, viewer: bool) -> None:
    """The flags every training entry point shares: saves, checkpoints,
    the device and (``viewer``) the training viewer's socket."""
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default="")
    if viewer:
        parser.add_argument("--ip", type=str, default="127.0.0.1")
        parser.add_argument("--port", type=int, default=6009)
        parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                             "it)")


def parse_full_config(parser: argparse.ArgumentParser, argv=None):
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    cfg = FullConfig(
        model=extract_dataclass(args, ModelConfig),
        pipe=extract_dataclass(args, PipelineConfig),
        opt=extract_dataclass(args, OptimizationConfig),
        runtime=extract_dataclass(args, RuntimeConfig))
    return cfg, args


def dump_cfg_args(cfg: FullConfig) -> None:
    """cfg_args file for tool re-use (train_*.py prepare_output pattern)."""
    import os
    from argparse import Namespace

    from ..io.meta import write_cfg_args
    if not cfg.model.model_path:
        import uuid
        cfg.model.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    ns = Namespace(**dataclasses.asdict(cfg.model))
    write_cfg_args(cfg.model.model_path, ns)
