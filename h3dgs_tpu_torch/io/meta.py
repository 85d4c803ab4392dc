"""Small inter-stage metadata formats (the filesystem is the pipeline API).

The port's own copy of ``h3dgs_tpu/io/meta.py``.

Formats pinned by the reference (SURVEY.md §5): exposure.json
(scene/__init__.py:106-114), pc_info.txt (gaussian_model.py:366-368),
center.txt / extent.txt (preprocess/make_chunk.py:209-245), chunks.txt
(preprocess/concat_chunks_info.py), depth_params.json
(preprocess/make_depth_scale.py), cameras.json (scene/__init__.py:49-61).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np


def write_exposure_json(path: str, exposures: Dict[str, np.ndarray]) -> None:
    """{image_name: 3x4 affine} (scene/__init__.py:106-114)."""
    out = {k: np.asarray(v, np.float32).tolist() for k, v in exposures.items()}
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


def read_exposure_json(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        raw = json.load(f)
    return {k: np.asarray(v, np.float32) for k, v in raw.items()}


def write_pc_info(path: str, n_skybox: int) -> None:
    with open(path, "w") as f:
        f.write(f"{n_skybox}\n")


def read_pc_info(path: str) -> int:
    with open(path) as f:
        return int(f.readline())


def write_vec(path: str, v: Sequence[float]) -> None:
    """center.txt / extent.txt: whitespace-separated floats on one line."""
    with open(path, "w") as f:
        f.write(" ".join(str(float(x)) for x in v) + "\n")


def read_vec(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray([float(x) for x in f.read().split()], np.float32)


def write_chunks_txt(path: str, chunks: List[dict]) -> None:
    """Each entry: {name, center [3], extent [3]} — consumed by the merger
    and viewer (preprocess/concat_chunks_info.py)."""
    with open(path, "w") as f:
        for c in chunks:
            cc = " ".join(str(float(x)) for x in c["center"])
            ee = " ".join(str(float(x)) for x in c["extent"])
            f.write(f"{c['name']} {cc} {ee}\n")


def read_chunks_txt(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            e = line.split()
            if not e:
                continue
            out.append({"name": e[0],
                        "center": np.asarray(e[1:4], np.float32),
                        "extent": np.asarray(e[4:7], np.float32)})
    return out


def read_depth_params(path: str) -> dict:
    """depth_params.json + med_scale augmentation
    (scene/dataset_readers.py:192-212)."""
    with open(path) as f:
        params = json.load(f)
    scales = np.asarray([params[k]["scale"] for k in params])
    med = float(np.median(scales[scales > 0])) if (scales > 0).any() else 0.0
    for k in params:
        params[k]["med_scale"] = med
    return params


def camera_to_json(idx: int, name: str, R: np.ndarray, T: np.ndarray,
                   width: int, height: int, fx: float, fy: float) -> dict:
    """cameras.json entry (utils/camera_utils.py:92-114 format)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.T
    Rt[:3, 3] = T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": idx, "img_name": name, "width": int(width),
        "height": int(height), "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fx": float(fx), "fy": float(fy),
    }


def write_cfg_args(model_path: str, args_namespace) -> None:
    """Dump the run config for tool re-use (train_*.py prepare_output)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(args_namespace))
