"""Drop useless calibrated images from a COLMAP model.

The port's own copy of ``h3dgs_tpu/preprocess/simplify.py`` (host numpy).
Equivalent of the reference's preprocess/simplify_images.py: remove
cameras with no SfM points or isolated by 2-NN distance > mult_min_dist x
median; strip invalid point refs; rename the original to
images_heavy.bin.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..io import colmap as C


def simplify_images(base_dir: str, mult_min_dist: float = 10.0) -> int:
    images_file = os.path.join(base_dir, "images.bin")
    images = C.read_images_binary(images_file)

    centers = np.array([
        -C.qvec2rotmat(im.qvec).T @ im.tvec for im in images.values()])
    d2 = np.sum((centers[:, None] - centers[None]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    nearest = np.sqrt(d2.min(axis=1))
    med = np.median(nearest)

    filtered = {}
    for (k, im), dist in zip(images.items(), nearest):
        if im.point3d_ids.size == 0 or dist > mult_min_dist * med:
            continue
        valid = im.point3d_ids >= 0
        if valid.sum() == 0:
            continue
        filtered[k] = dataclasses.replace(
            im, xys=im.xys[valid], point3d_ids=im.point3d_ids[valid])

    heavy = os.path.join(base_dir, "images_heavy.bin")
    if os.path.exists(heavy):
        os.remove(heavy)
    os.rename(images_file, heavy)
    C.write_images_binary(images_file, filtered)
    print(f"{len(images)} images before; {len(filtered)} after")
    return len(filtered)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base_dir", required=True)
    p.add_argument("--mult_min_dist", type=float, default=10)
    a = p.parse_args(argv)
    simplify_images(a.base_dir, a.mult_min_dist)


if __name__ == "__main__":
    main()
