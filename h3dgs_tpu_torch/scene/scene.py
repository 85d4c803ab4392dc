"""Scene: binds a COLMAP dataset to a GaussianState and its artifacts on
disk (counterpart of ``h3dgs_tpu/scene/scene.py``).

Loads the COLMAP scene, dumps ``cameras.json`` + ``input.ply``, computes
the NeRF++ extent, initializes the model (pretrained point cloud or input
point cloud with skybox / scaffold) on ``device``, and saves stage
artifacts (``point_cloud/iteration_N/point_cloud.ply`` + ``pc_info.txt``,
``exposure.json``, the post-optimized hierarchy ``<hier>_opt``) in the
reference's formats. ``create_from_hier`` builds the post-training state
from ``model_cfg.hierarchy`` (hierarchy rows, then the scaffold's skybox
rows) with its anchor mask and the pretrained exposures found beside the
hierarchy. A scene past ``PLY_MAX_POINTS`` is saved, and loaded, in the
packed ``.pt`` format (``io/pt.py``).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np

from ..config import ModelConfig, RuntimeConfig
from ..io import meta as meta_io
from ..io import pt as pt_io
from ..io.ply import read_gaussian_ply, write_gaussian_ply
from ..model import state as state_lib
from ..hierarchy.io import read_hier, write_hier
from ..model.init import (init_from_pcd, state_from_hierarchy,
                          update_hierarchy_from_state)
from ..utils.camera_math import fov2focal
from ..utils.runtime import resolve_device
from .dataset import SceneInfo, read_colmap_scene
from .loader import ViewStream

PLY_MAX_POINTS = 8_000_000


class Scene:
    def __init__(self, model_cfg: ModelConfig,
                 runtime: Optional[RuntimeConfig] = None,
                 create_from_hier: bool = False, seed: int = 0,
                 load_iteration: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.runtime = runtime or RuntimeConfig()
        self.model_path = model_cfg.model_path
        os.makedirs(self.model_path, exist_ok=True)

        self.info: SceneInfo = read_colmap_scene(
            model_cfg.source_path, model_cfg.images, model_cfg.alpha_masks,
            model_cfg.depths, eval_split=model_cfg.eval,
            train_test_exp=model_cfg.train_test_exp)
        self.cameras_extent = self.info.radius

        if load_iteration is None:
            self._dump_scene_metadata()

        self.anchor_mask = None
        self.hierarchy = None
        if load_iteration is not None:
            if load_iteration == -1:  # latest (searchForMaxIteration)
                base = os.path.join(self.model_path, "point_cloud")
                iters = [int(d.split("_")[-1]) for d in os.listdir(base)
                         if d.startswith("iteration_")]
                load_iteration = max(iters)
            pc_dir = os.path.join(self.model_path, "point_cloud",
                                  f"iteration_{load_iteration}")
            self.state = self._load_point_cloud_dir(pc_dir)
        elif create_from_hier:
            self.hierarchy = read_hier(model_cfg.hierarchy)
            self.state, self.anchor_mask = state_from_hierarchy(
                self.hierarchy, model_cfg.scaffold_file,
                max_sh_degree=model_cfg.sh_degree, device=self.device)
        elif model_cfg.pretrained:
            self.state = self._load_point_cloud_dir(model_cfg.pretrained)
        else:
            center = extent = None
            if model_cfg.bounds_file:
                center = meta_io.read_vec(
                    os.path.join(model_cfg.bounds_file, "center.txt"))
                extent = meta_io.read_vec(
                    os.path.join(model_cfg.bounds_file, "extent.txt"))
            self.state = init_from_pcd(
                self.info.point_cloud_xyz, self.info.point_cloud_rgb,
                capacity=self.runtime.capacity or None,
                capacity_factor=self.runtime.capacity_factor,
                max_sh_degree=model_cfg.sh_degree,
                skybox_points=model_cfg.skybox_num,
                scaffold_dir=model_cfg.scaffold_file,
                chunk_center=center, chunk_extent=extent, seed=seed,
                device=self.device)

        # Per-train-image exposure rows (identity 3x4 init).
        self.image_names = [c.image_name for c in self.info.train_cameras]
        self.exposures = np.tile(np.eye(3, 4, dtype=np.float32)[None],
                                 (max(len(self.image_names), 1), 1, 1))
        # The per-chunk stage's exposures, applied (never optimized) by
        # post-training: beside the hierarchy's directory or inside it.
        self.pretrained_exposures: Optional[Dict[str, np.ndarray]] = None
        if create_from_hier:
            hier_dir = os.path.dirname(model_cfg.hierarchy)
            for cand in (os.path.join(hier_dir, "../exposure.json"),
                         os.path.join(hier_dir, "exposure.json")):
                if os.path.exists(cand):
                    self.pretrained_exposures = meta_io.read_exposure_json(
                        cand)
                    break

    # ------------------------------------------------------------- io ---
    def _dump_scene_metadata(self):
        if os.path.exists(self.info.ply_path):
            try:
                shutil.copyfile(self.info.ply_path,
                                os.path.join(self.model_path, "input.ply"))
            except OSError:
                pass
        cams = list(self.info.test_cameras) + list(self.info.train_cameras)
        json_cams = [
            meta_io.camera_to_json(
                i, c.image_name, c.R, c.T, c.width, c.height,
                fov2focal(c.fovx, c.width), fov2focal(c.fovy, c.height))
            for i, c in enumerate(cams)]
        with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
            json.dump(json_cams, f)

    def _load_point_cloud_dir(self, pc_dir: str) -> state_lib.GaussianState:
        """Load point_cloud.ply, the packed >8M-point format or
        point_cloud.npz."""
        n_skybox = 0
        info = os.path.join(pc_dir, "pc_info.txt")
        if os.path.exists(info):
            n_skybox = meta_io.read_pc_info(info)
        ply = os.path.join(pc_dir, "point_cloud.ply")
        if os.path.exists(ply):
            g = read_gaussian_ply(ply, self.cfg.sh_degree)
        elif os.path.exists(os.path.join(pc_dir, "done_xyz.pt")):
            g = pt_io.load_pt(pc_dir)
        else:
            g = dict(np.load(os.path.join(pc_dir, "point_cloud.npz")))
        capacity = self.runtime.capacity or None
        if capacity is None and self.runtime.capacity_factor > 1:
            capacity = int(len(g["xyz"]) * self.runtime.capacity_factor)
        return state_lib.from_arrays(
            g["xyz"], g["features_dc"], g["features_rest"], g["opacity"],
            g["scaling"], g["rotation"], capacity=capacity,
            max_sh_degree=self.cfg.sh_degree, device=self.device,
            n_skybox=n_skybox)

    def train_stream(self, seed: int = 0, num_workers: int = 8,
                     shuffle: bool = True, keep_fn=None) -> ViewStream:
        return ViewStream(self.info.train_cameras, self.device,
                          resolution=self.cfg.resolution,
                          train_test_exp=self.cfg.train_test_exp,
                          num_workers=num_workers, seed=seed,
                          shuffle=shuffle, keep_fn=keep_fn)

    def save(self, iteration: int, state: state_lib.GaussianState,
             exposures: Optional[np.ndarray] = None,
             hierarchy=None) -> str:
        """Stage artifacts (Scene.save of the reference). With
        ``hierarchy``, the state's rows [0, M) go back into it and it is
        written to ``<model_cfg.hierarchy>_opt``."""
        pc_dir = os.path.join(self.model_path, "point_cloud",
                              f"iteration_{iteration}")
        os.makedirs(pc_dir, exist_ok=True)
        if hierarchy is not None:
            out = self.cfg.hierarchy + "_opt"
            write_hier(out, update_hierarchy_from_state(hierarchy, state),
                       sh_degree=self.cfg.sh_degree)
            return out

        meta_io.write_pc_info(os.path.join(pc_dir, "pc_info.txt"),
                              state.n_skybox)
        alive = state.alive.cpu().numpy()
        k_rest = (self.cfg.sh_degree + 1) ** 2 - 1
        arrs = dict(
            xyz=state.xyz.cpu().numpy(),
            features_dc=state.features_dc.cpu().numpy(),
            features_rest=state.features_rest.cpu().numpy()[:, :k_rest],
            opacity=state.opacity.cpu().numpy(),
            scaling=state.scaling.cpu().numpy(),
            rotation=state.rotation.cpu().numpy())
        # Keep the protected prefix in place; compact the rest to alive rows
        # (fixed-capacity layout -> the reference's dense layout).
        keep = alive.copy()
        keep[:max(state.n_skybox if not state.skybox_last else 0,
                  state.n_scaffold)] = True
        arrs = {k: v[keep] for k, v in arrs.items()}
        n = arrs["xyz"].shape[0]
        if n > PLY_MAX_POINTS:
            # The reference's raw-tensor format for huge scenes.
            pt_io.save_pt(pc_dir, **arrs)
        else:
            write_gaussian_ply(os.path.join(pc_dir, "point_cloud.ply"),
                               **arrs)
        if exposures is not None:
            exp = {name: exposures[i]
                   for i, name in enumerate(self.image_names)}
            meta_io.write_exposure_json(
                os.path.join(self.model_path, "exposure.json"), exp)
        return pc_dir
