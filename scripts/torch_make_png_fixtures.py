#!/usr/bin/env python3
"""Write the PNG and area-resize fixtures of the port's image contracts
(``h3dgs_tpu_torch/io/image.py``, ``preprocess/imgproc.py``) under
``tests/data/torch_png/``, with a ``manifest.json``.

PNG: one file of every kind the specification allows (gray at 1, 2, 4, 8
and 16 bits, RGB at 8 and 16, palette at 1, 2, 4 and 8, each with and
without ``tRNS``; gray+alpha and RGBA at 8 and 16), each non-interlaced
and Adam7, written by this script with the port's ``encode_png_samples``
(PIL and OpenCV write no Adam7 file): 41x37 seeded samples, so that every
Adam7 pass holds five rows or more and each pass's rows go under all five
filter types, and rows of sub-byte pixels end inside a byte. The script
asserts that PIL and OpenCV decode each file to its samples. Then a few
files PIL and OpenCV write themselves (PIL's ``"1"``, 2- and 4-bit ``"P"``
with transparency, ``I;16`` and ``LA``; OpenCV's bilevel, 16-bit gray and
16-bit BGRA). For each file the manifest gives the SHA-256 (dtype and
shape included, ``digest``) of the five arrays the JAX package's callers
see: ``np.asarray(Image.open(f))``, its ``convert("RGBA" if mode ==
"RGBA" else "RGB")``, and ``cv2.imread`` with ``IMREAD_UNCHANGED``,
``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE``.

Resize: small float32 images (``resize_<case>_src.npy``) and
``cv2.resize(src, ..., interpolation=cv2.INTER_AREA)`` of each
(``resize_<case>_want.npy``) at the factors of
``tests/test_torch_image_contracts.py``: 1.25, 1.6, 2.5 and 3.42 wide,
an enlargement by 1.2, slivers under 1e-3, a one-pixel-wide side and a
4032-wide strip shrunk to 1600, on 1, 3 and 4 channels; the manifest
gives each case's tolerance (0: OpenCV's result bit for bit).

The card's machine has neither PIL nor OpenCV; ``chip_smoke.py`` holds the
port's decodes and resizes to these files.

Run: python3 scripts/torch_make_png_fixtures.py [--out DIR]
(needs PIL and OpenCV; the manifest always matches the files it is
written with)
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys
import warnings

import cv2
import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from h3dgs_tpu_torch.io.image import encode_png_samples  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "torch_png")
KINDS = ([(0, d, t) for d in (1, 2, 4, 8, 16) for t in (False, True)]
         + [(2, d, t) for d in (8, 16) for t in (False, True)]
         + [(3, d, t) for d in (1, 2, 4, 8) for t in (False, True)]
         + [(c, d, False) for c in (4, 6) for d in (8, 16)])
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
H, W = 41, 37
# (name, source shape, destination (h, w)); the source is uniform in [0, 1)
RESIZE = [("x1.25", (45, 80, 3), (36, 64)),
          ("x1.6", (45, 80), (28, 50)),
          ("x2.5", (45, 80, 4), (18, 32)),
          ("x3.42", (60, 171, 3), (17, 50)),
          ("enlarge1.2", (45, 80, 3), (54, 96)),
          ("sliver", (6, 4001), (3, 2000)),
          ("one_wide", (225, 1), (90, 1)),
          ("strip4032", (2, 4032, 3), (1, 1600))]


def digest(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and values."""
    head = f"{a.dtype.str}{a.shape}".encode()
    # PIL's bool arrays hold True as byte 255: hash the values, 0 or 1.
    a = np.ascontiguousarray(a, np.uint8 if a.dtype == bool else a.dtype)
    return hashlib.sha256(head + a.tobytes()).hexdigest()


def contracts(path: str) -> dict:
    """The five arrays' digests, and PIL's mode."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # P with tRNS -> RGB
        with Image.open(path) as im:
            mode = im.mode
            arr = np.asarray(im)
            rgb = np.asarray(im.convert("RGBA" if mode == "RGBA" else "RGB"))
    return {"pil_mode": mode, "pil_array": digest(arr),
            "pil_rgb": digest(rgb),
            "cv2_unchanged": digest(cv2.imread(path, cv2.IMREAD_UNCHANGED)),
            "cv2_color": digest(cv2.imread(path, cv2.IMREAD_COLOR)),
            "cv2_gray": digest(cv2.imread(path, cv2.IMREAD_GRAYSCALE))}


def kind_file(kind, interlace: bool, rng):
    """(name, bytes, samples, palette, trns) of one kind: smooth rows and
    noise, a palette shorter than the depth allows, a tRNS shorter than
    the palette or a key that occurs."""
    ctype, depth, with_trns = kind
    top = (1 << depth) - 1
    palette = trns = None
    if ctype == 3:
        n = max(2, min(top + 1, 200) - 3)
        palette = rng.integers(0, 256, (n, 3))
        top = n - 1
        if with_trns:
            trns = rng.integers(0, 256, max(1, n - 2))
    s = rng.integers(0, top + 1, (H, W, CHANNELS[ctype]))
    ramp = np.linspace(0, top, W).astype(np.int64)[:, None]
    s[: H // 2] = np.clip(ramp + 3 * np.arange(H // 2)[:, None, None], 0,
                          top)
    if with_trns and ctype in (0, 2):
        trns = s[0, 0]
    s = s.astype(np.uint16 if depth == 16 else np.uint8)
    body = encode_png_samples(s, depth, ctype, palette, trns, interlace,
                              filters=(0, 1, 2, 3, 4))
    name = (f"c{ctype}_d{depth}{'_trns' if with_trns else ''}"
            f"{'_adam7' if interlace else ''}_{W}x{H}.png")
    return name, body, s, palette, trns


def check_source(path: str, kind, s, palette) -> None:
    """PIL and OpenCV decode a written file to its samples."""
    ctype, depth, _ = kind
    with Image.open(path) as im:
        pil = np.asarray(im)
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ctype == 3:
        assert np.array_equal(pil, s[..., 0]), path
        assert np.array_equal(raw[..., 2::-1], palette[s[..., 0]]), path
        return
    if ctype == 0:
        want = s[..., 0] * (255 // ((1 << depth) - 1)) if depth < 8 \
            else s[..., 0]
        assert np.array_equal(raw, want), path
        assert np.array_equal(pil, s[..., 0].astype(bool) if depth == 1
                              else want), path
        return
    if ctype == 4:
        assert np.array_equal(raw[..., [0, 3]], s), path
    else:
        assert np.array_equal(raw[..., 2::-1], s[..., :3]), path
        if ctype == 6:
            assert np.array_equal(raw[..., 3], s[..., 3]), path
    if depth == 8:
        assert np.array_equal(pil, s), path


def library_files(rng) -> dict:
    """{name: PNG bytes} written by PIL and OpenCV themselves."""
    out = {}
    yy, xx = np.mgrid[:H, :W]

    def pil(img, **kw):
        buf = io.BytesIO()
        img.save(buf, "PNG", **kw)
        return buf.getvalue()

    def ocv(img, *params):
        ok, buf = cv2.imencode(".png", img, list(params))
        assert ok
        return buf.tobytes()

    blob = ((xx - W / 2) ** 2 + (yy - H / 2) ** 2 < 150)
    out["pil_mode1_mask.png"] = pil(Image.fromarray(blob).convert("1"))
    for bits in (2, 4):
        idx = rng.integers(0, 1 << bits, (H, W)).astype(np.uint8)
        im = Image.fromarray(idx, "P")
        im.putpalette(rng.integers(0, 256, 3 << bits).astype(
            np.uint8).tobytes())
        out[f"pil_P_bits{bits}_trns.png"] = pil(
            im, bits=bits, transparency=bytes(range(0, 250, 60)))
    out["pil_I16.png"] = pil(Image.fromarray(
        rng.integers(0, 65536, (H, W)).astype(np.uint16)))
    out["pil_LA.png"] = pil(Image.fromarray(
        rng.integers(0, 256, (H, W, 2)).astype(np.uint8), "LA"))
    out["cv2_bilevel.png"] = ocv(blob.astype(np.uint8) * 255,
                                 cv2.IMWRITE_PNG_BILEVEL, 1)
    out["cv2_gray16.png"] = ocv(
        rng.integers(0, 65536, (H, W)).astype(np.uint16))
    out["cv2_bgra16.png"] = ocv(
        rng.integers(0, 65536, (H, W, 4)).astype(np.uint16))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(11)
    manifest = {"png": {}, "resize": {}}
    for kind in KINDS:
        for interlace in (False, True):
            name, body, s, palette, _ = kind_file(kind, interlace, rng)
            path = os.path.join(args.out, name)
            with open(path, "wb") as f:
                f.write(body)
            check_source(path, kind, s, palette)
            manifest["png"][name] = {
                "kind": f"colour type {kind[0]}, {kind[1]} bits"
                        + (", tRNS" if kind[2] else "")
                        + (", Adam7" if interlace else ""),
                **contracts(path)}
    for name, body in library_files(rng).items():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(body)
        manifest["png"][name] = {"kind": "written by "
                                 + name.split("_")[0].replace("cv2",
                                                              "OpenCV"),
                                 **contracts(path)}
    for name, shape, (h, w) in RESIZE:
        src = rng.uniform(0, 1, shape).astype(np.float32)
        want = cv2.resize(src, (w, h), interpolation=cv2.INTER_AREA)
        files = {k: f"resize_{name}_{k}.npy" for k in ("src", "want")}
        np.save(os.path.join(args.out, files["src"]), src)
        np.save(os.path.join(args.out, files["want"]), want)
        manifest["resize"][name] = {**files, "atol": 0.0}
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, n))
                for n in os.listdir(args.out))
    print(f"{len(manifest['png'])} PNG files, {len(manifest['resize'])} "
          f"resize cases, {total} bytes -> {args.out}")


if __name__ == "__main__":
    main()
