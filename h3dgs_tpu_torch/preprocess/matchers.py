"""COLMAP match-pair list generation.

The port's own copy of ``h3dgs_tpu/preprocess/matchers.py`` (host). GPS
positions come from the port's EXIF reader (``io/exif.py``), not PIL.
Equivalents of the reference's preprocess/make_colmap_custom_matcher.py
(per-camera-folder sequential + quadratic 2^k frame offsets, optional
loop-closure windows, GPS-EXIF k-NN pairs, dedup with reciprocal removal)
and make_colmap_custom_matcher_distance.py (k-NN over calibrated camera
centers, used for per-chunk re-matching).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..io.exif import read_gps_ifd

# GPS IFD tags (EXIF 2.3, table 12)
GPS_LATITUDE_REF, GPS_LATITUDE = 1, 2
GPS_LONGITUDE_REF, GPS_LONGITUDE = 3, 4


def find_image_folders(root_dir: str) -> List[dict]:
    """Sorted image lists per camera subfolder (matcher.py:49-66)."""
    out = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root_dir)):
        imgs = sorted(f for f in filenames
                      if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if imgs:
            rel = os.path.relpath(dirpath, root_dir)
            out.append({"dir": "" if rel == "." else rel, "images": imgs})
    return out


def _gps_coords(image_path: str) -> Optional[list]:
    """Decimal GPS coordinates [latitude, longitude] from EXIF, as the JAX
    package reads them through PIL's ``_getexif``; ``None`` for a file
    that is not a JPEG, has no EXIF block, no GPS IFD, or no full latitude
    and longitude."""
    gps = read_gps_ifd(image_path)
    if not gps:
        return None
    lat, lon = gps.get(GPS_LATITUDE), gps.get(GPS_LONGITUDE)
    if not (isinstance(lat, tuple) and len(lat) >= 3
            and isinstance(lon, tuple) and len(lon) >= 3):
        return None

    def dec(coords, ref):
        d = float(coords[0]) + float(coords[1]) / 60 \
            + float(coords[2]) / 3600
        return -d if ref in ("S", "W") else d

    return [dec(lat, gps.get(GPS_LATITUDE_REF, "N")),
            dec(lon, gps.get(GPS_LONGITUDE_REF, "E"))]


def make_matcher_file(
    image_path: str, output_path: str,
    n_seq_matches_per_view: int = 0,
    n_quad_matches_per_view: int = 10,
    n_loop_closure_match_per_view: int = 5,
    loop_matches: Optional[List[int]] = None,
    n_gps_neighbours: int = 25,
) -> int:
    """Write the match-pair list; returns the number of pairs."""
    folders = find_image_folders(image_path)
    loops = np.asarray(loop_matches or [], np.int64).reshape(-1, 2)
    rel = 2 ** np.arange(n_loop_closure_match_per_view)
    loop_rel = np.concatenate([-rel[::-1], [0], rel])

    matches: List[str] = []

    def add(cur_cam, matched_cam, cur_file, matched_fid):
        if 0 <= matched_fid < len(matched_cam["images"]):
            a = os.path.join(cur_cam["dir"], cur_file)
            b = os.path.join(matched_cam["dir"],
                             matched_cam["images"][matched_fid])
            matches.append(f"{a} {b}\n")

    for ci, cur in enumerate(folders):
        for matched in folders[ci:]:
            for fid, cur_file in enumerate(cur["images"]):
                for step in range(n_seq_matches_per_view):
                    add(cur, matched, cur_file, fid + step)
                for m in range(n_quad_matches_per_view):
                    step = n_seq_matches_per_view + (1 << m) - 1
                    add(cur, matched, cur_file, fid + step)
            for lm in loops:
                for dr in loop_rel:
                    cid = int(lm[0] + dr)
                    if 0 <= cid < len(cur["images"]):
                        for dm in loop_rel:
                            add(cur, matched, cur["images"][cid],
                                int(lm[1] + dm))

    if n_gps_neighbours > 0:
        names, coords = [], []
        for cam in folders:
            for f in cam["images"]:
                rel_name = os.path.join(cam["dir"], f)
                c = _gps_coords(os.path.join(image_path, rel_name))
                if c is not None:
                    names.append(rel_name)
                    coords.append(c)
        if coords:
            coords = np.asarray(coords)
            k = min(n_gps_neighbours, len(names))
            d2 = np.sum((coords[:, None] - coords[None]) ** 2, axis=-1)
            nn = np.argsort(d2, axis=1)[:, 1:k]
            for i, name in enumerate(names):
                for j in nn[i]:
                    matches.append(f"{name} {names[j]}\n")

    out = _dedup_reciprocal(matches)
    with open(output_path, "w") as f:
        f.write("".join(out))
    return len(out)


def _dedup_reciprocal(matches):
    """Dedup pairs, keeping one direction of each reciprocal pair (the
    reference's version drops both, matcher.py:146-152 — a bug we fix)."""
    seen = set()
    out = []
    for m in dict.fromkeys(matches):
        a, b = m.split()
        if (b, a) in seen or (a, b) in seen:
            continue
        seen.add((a, b))
        out.append(m)
    return out


def make_distance_matcher_file(sparse_dir: str, output_path: str,
                               n_neighbours: int = 100) -> int:
    """k-NN match pairs from calibrated camera centers
    (make_colmap_custom_matcher_distance.py; chunk prep uses 200)."""
    from ..io import colmap as C
    from .reorient import camera_centers

    _, images, _ = C.read_model(sparse_dir)
    keys = list(images.keys())
    centers = camera_centers(images)
    k = min(n_neighbours, len(keys))
    d2 = np.sum((centers[:, None] - centers[None]) ** 2, axis=-1)
    # [:, 1:k] drops self and yields k-1 neighbors — matching the
    # reference's NearestNeighbors(k).kneighbors()[..., 1:] behavior.
    nn = np.argsort(d2, axis=1)[:, 1:k]
    matches = []
    for i, key in enumerate(keys):
        for j in nn[i]:
            matches.append(f"{images[key].name} {images[keys[j]].name}\n")
    out = _dedup_reciprocal(matches)
    with open(output_path, "w") as f:
        f.write("".join(out))
    return len(out)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--n_seq_matches_per_view", type=int, default=0)
    p.add_argument("--n_quad_matches_per_view", type=int, default=10)
    p.add_argument("--n_loop_closure_match_per_view", type=int, default=5)
    p.add_argument("--loop_matches", nargs="*", type=int, default=[])
    p.add_argument("--n_gps_neighbours", type=int, default=25)
    a = p.parse_args(argv)
    n = make_matcher_file(a.image_path, a.output_path,
                          a.n_seq_matches_per_view,
                          a.n_quad_matches_per_view,
                          a.n_loop_closure_match_per_view,
                          a.loop_matches, a.n_gps_neighbours)
    print(f"{n} match pairs -> {a.output_path}")


if __name__ == "__main__":
    main()
