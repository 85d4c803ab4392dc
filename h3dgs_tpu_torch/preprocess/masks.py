"""Mask utilities.

The port's own copy of ``h3dgs_tpu/preprocess/masks.py``. Equivalents of
the reference's preprocess/make_mask_uint8.py (undistorted RGBA masks ->
eroded uint8 binary masks) and black_mask.py (zero out masked pixels
directly in the images).

Files are decoded with OpenCV's channel semantics (``imgproc``) in host
threads; the threshold, erosion and resize run on the device. A PNG comes
out pixel-equal to the JAX package's (the bytes differ: OpenCV's encoder
filters rows, this one does not). ``black_mask_images`` writes a JPEG
(``.jpg``, ``.jpeg``) back through ``io.image.write_image`` at OpenCV's
default quality 95 with the port's own encoder: the bytes ``cv2.imwrite``
writes for the JAX package, upright as ``cv2.imread`` turned it by its
EXIF orientation, and without EXIF (H21 in ``ROADMAP.md``).
"""
from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np
import torch

from ..io.image import write_image
from ..utils.runtime import DeviceLike, resolve_device
from .imgproc import (erode as erode_min, load_bgr8, load_gray8,
                      load_unchanged, resize_nearest)


def _binary_mask(path: str, dst: str, erode: int,
                 device: torch.device) -> None:
    img = load_unchanged(path)
    alpha = img[..., 3] if img.ndim == 3 and img.shape[2] == 4 \
        else (img if img.ndim == 2 else img[..., 0])
    a = torch.from_numpy(alpha.astype(np.int32)).to(device)
    binary = (a > 127).to(torch.uint8) * 255
    write_image(dst, erode_min(binary, erode).cpu().numpy())


def make_masks_uint8(in_dir: str, out_dir: str, erode: int = 5,
                     device: DeviceLike = None) -> int:
    """Binary masks (alpha > 127, or OpenCV's channel 0 of an image
    without alpha) eroded by an all-ones ``erode`` x ``erode`` kernel,
    written as 8-bit gray PNGs under the same relative paths."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for root, _dirs, files in os.walk(in_dir):
        for f in sorted(files):
            if not f.lower().endswith((".png", ".jpg")):
                continue
            rel = os.path.relpath(root, in_dir)
            dst_dir = os.path.join(out_dir, rel) if rel != "." else out_dir
            os.makedirs(dst_dir, exist_ok=True)
            stem = os.path.splitext(f)[0]
            jobs.append((os.path.join(root, f),
                         os.path.join(dst_dir, stem + ".png")))
    with cf.ThreadPoolExecutor() as pool:
        list(pool.map(lambda job: _binary_mask(*job, erode, device), jobs))
    print(f"{len(jobs)} masks -> {out_dir}")
    return len(jobs)


def _black_mask(img_path: str, mask_path: str,
                device: torch.device) -> None:
    img = torch.from_numpy(load_bgr8(img_path)).to(device)
    mask = torch.from_numpy(load_gray8(mask_path)).to(device)
    if mask.shape[:2] != img.shape[:2]:
        mask = resize_nearest(mask, img.shape[0], img.shape[1])
    img[mask < 128] = 0
    write_image(img_path, img.cpu().numpy()[..., ::-1])


def black_mask_images(images_dir: str, masks_dir: str,
                      device: DeviceLike = None) -> int:
    """Zero out masked pixels in place (black_mask.py): the image read as
    8-bit BGR, the mask as 8-bit gray and resized nearest-neighbour to the
    image when their sizes differ, pixels where the mask is below 128
    set to 0. Images without a mask are left alone."""
    device = resolve_device(device)
    jobs = []
    for root, _dirs, files in os.walk(images_dir):
        for f in sorted(files):
            if not f.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            rel = os.path.relpath(root, images_dir)
            stem = os.path.splitext(f)[0]
            mask_path = os.path.join(masks_dir, rel if rel != "." else "",
                                     stem + ".png")
            if os.path.exists(mask_path):
                jobs.append((os.path.join(root, f), mask_path))
    with cf.ThreadPoolExecutor() as pool:
        list(pool.map(lambda job: _black_mask(*job, device), jobs))
    return len(jobs)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("uint8")
    a.add_argument("--in_dir", required=True)
    a.add_argument("--out_dir", required=True)
    a.add_argument("--erode", type=int, default=5)
    b = sub.add_parser("black")
    b.add_argument("--images_dir", required=True)
    b.add_argument("--masks_dir", required=True)
    for q in (a, b):
        q.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.cmd == "uint8":
        make_masks_uint8(args.in_dir, args.out_dir, args.erode, args.device)
    else:
        black_mask_images(args.images_dir, args.masks_dir, args.device)


if __name__ == "__main__":
    main()
