"""COLMAP SQLite database helper + pre-population from a known model.

The port's own copy of ``h3dgs_tpu/preprocess/colmap_db.py``
(host, sqlite3).

Equivalent of the reference's preprocess/database.py (the stock COLMAP
schema) + fill_database.py: creates a database whose cameras/images reuse
the calibrated intrinsics and ids of an existing model, so COLMAP's
feature_extractor keeps them fixed during per-chunk refinement
(the reference's preprocess/prepare_chunk.py:61-110 flow).

Schema follows the public COLMAP 3.x database layout.
"""
from __future__ import annotations

import os
import sqlite3

import numpy as np

from ..io import colmap as C

MAX_IMAGE_ID = 2 ** 31 - 1

SCHEMA = f"""
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL,
    height INTEGER NOT NULL, params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and
                                    image_id < {MAX_IMAGE_ID}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


class ColmapDatabase:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(SCHEMA)

    def close(self):
        self.conn.commit()
        self.conn.close()

    def add_camera(self, cam: C.ColmapCamera,
                   prior_focal_length: bool = True):
        model_id = C.CAMERA_MODEL_IDS[cam.model]
        params = np.asarray(cam.params, np.float64).tobytes()
        self.conn.execute(
            "INSERT OR REPLACE INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (cam.id, model_id, cam.width, cam.height, params,
             int(prior_focal_length)))

    def add_image(self, image: C.ColmapImage):
        self.conn.execute(
            "INSERT OR REPLACE INTO images VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image.id, image.name, image.camera_id,
             *map(float, image.qvec), *map(float, image.tvec)))


def fill_database(db_path: str, sparse_dir: str) -> None:
    """Create a database pre-populated with the model's cameras/images
    (fill_database.py behavior; ids preserved)."""
    os.makedirs(os.path.dirname(db_path) or ".", exist_ok=True)
    cams, images, _ = C.read_model(sparse_dir)
    db = ColmapDatabase(db_path)
    for cam in cams.values():
        db.add_camera(cam)
    for im in images.values():
        db.add_image(im)
    db.close()
    print(f"database with {len(cams)} cameras / {len(images)} images "
          f"-> {db_path}")


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--database_path", required=True)
    p.add_argument("--sparse_dir", required=True)
    a = p.parse_args(argv)
    fill_database(a.database_path, a.sparse_dir)


if __name__ == "__main__":
    main()
