#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's decoder and encoder
(``h3dgs_tpu_torch/io/jpeg.py``, ``io/jpeg_encode.py``) under
``tests/data/torch_jpeg/``, with a ``manifest.json``.

Each file is made with PIL or OpenCV from a seeded numpy texture: the
chroma subsamplings 4:4:4, 4:2:2 and 4:2:0 (PIL) and 4:1:1 and 4:4:0
(OpenCV), odd sizes from 1x1 to 257x129, qualities 50, 90 and 100,
optimised Huffman tables, restart intervals, gray, Adobe RGB, EXIF with
GPS and orientation 6 and 8, 16-bit quantisation tables (extended
sequential, SOF1) and one 1600x900 4:2:0 view, the width the reference's
loader trains at; then progressive files (SOF2) of every kind: PIL 4:4:4,
4:2:2, 4:2:0 and gray, OpenCV 4:1:1 and 4:4:0, restart intervals,
``optimize``, a 1600x900 twin of the view from the same texture (it
decodes to the view's pixels), and one cut after its DC scans (EOI
appended), whose unfinished scans libjpeg-turbo smooths and the port
refuses. The manifest gives, for each file, its kind, whether it is
progressive and refused, the shape and SHA-256 of PIL's decoded pixels
(``np.asarray(Image.open(f))``) and, where OpenCV's default read differs
(an EXIF orientation other than 1), the shape and SHA-256 of
``cv2.imread(f)`` (BGR, turned upright); and, for each file the port
decodes, the SHA-256 of PIL's JPEG of those pixels at the qualities of
``ENCODE_QUALITIES`` (``save(f, "JPEG", quality=q)``, RGB or gray as
decoded). The card's machine has neither PIL nor OpenCV;
``chip_smoke.py`` holds the port's decodes and encodes to these digests.

Run: python3 scripts/torch_make_jpeg_fixtures.py [--out DIR]
(needs PIL and OpenCV; the files depend on their libjpeg versions, the
manifest always matches the files it is written with)
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import os

import cv2
import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_jpeg")
GPS = {1: "N", 2: (48.0, 51.0, 29.5), 3: "E", 4: (2.0, 17.0, 40.2)}
# -1 is PIL's default (75); the others span libjpeg's scale at both ends
ENCODE_QUALITIES = (1, 50, 75, 85, 95, 100, -1)


def texture(rng, h: int, w: int, channels: int = 3,
            noise: float = 24.0) -> np.ndarray:
    """Smooth colour waves with seeded noise: edges, gradients and detail
    in every block, [h, w, channels] uint8."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    waves = []
    for c in range(channels):
        fx, fy, ph = rng.uniform(0.01, 0.2, 2).tolist() + [rng.uniform(0, 6)]
        waves.append(128 + 90 * np.sin(fx * xx + ph) * np.cos(fy * yy)
                     + 30 * np.sign(np.sin(0.05 * (xx + 2 * yy) + c)))
    img = np.stack(waves, -1) + rng.normal(0, noise, (h, w, channels))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def save_pil(path: str, img: np.ndarray, **kw) -> None:
    Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img).save(
        path, "JPEG", **kw)


def save_cv2(path: str, img: np.ndarray, sampling: int, quality: int,
             restart: int = 0, progressive: bool = False) -> None:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    assert cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]), params)


def exif_bytes(orientation: int) -> bytes:
    ex = Image.Exif()
    ex[0x0112] = orientation
    ex[0x8825] = GPS
    return ex.tobytes()


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def encoded_digests(pixels: np.ndarray) -> dict:
    """quality -> SHA-256 of PIL's JPEG of ``pixels``."""
    out = {}
    for q in ENCODE_QUALITIES:
        b = io.BytesIO()
        Image.fromarray(pixels).save(b, "JPEG", quality=q)
        out[str(q)] = hashlib.sha256(b.getvalue()).hexdigest()
    return out


def save_dc_only(path: str, img: np.ndarray) -> None:
    """PIL's progressive file cut after its first (DC) scan, EOI
    appended: every AC coefficient unsent."""
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", quality=90, progressive=True)
    buf = b.getvalue()
    first = buf.index(b"\xff\xda")
    second = buf.index(b"\xff\xda", first + 2)
    # the DHT segments PIL writes before the second scan belong to it
    cut = buf.rindex(b"\xff\xc4", first, second) \
        if b"\xff\xc4" in buf[first:second] else second
    with open(path, "wb") as f:
        f.write(buf[:cut] + b"\xff\xd9")


def fixtures(rng):
    """(name, kind, writer) for every fixture."""
    s411 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411
    s440 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440
    out = []
    for (h, w), sub, q in (((1, 1), 2, 90), ((17, 13), 0, 90),
                           ((17, 13), 2, 50), ((97, 61), 1, 50),
                           ((61, 97), 2, 100), ((129, 257), 0, 100),
                           ((129, 257), 1, 90), ((129, 257), 2, 90)):
        name = f"pil_{('444', '422', '420')[sub]}_q{q}_{w}x{h}.jpg"
        img = texture(rng, h, w)
        out.append((name, f"PIL {('4:4:4', '4:2:2', '4:2:0')[sub]} q{q}",
                    lambda p, img=img, sub=sub, q=q: save_pil(
                        p, img, quality=q, subsampling=sub)))
    for (h, w), samp, tag in (((61, 97), s411, "411"),
                              ((129, 257), s411, "411"),
                              ((61, 97), s440, "440"),
                              ((129, 257), s440, "440")):
        img = texture(rng, h, w)
        out.append((f"cv2_{tag}_rst_{w}x{h}.jpg",
                    f"OpenCV {tag[0]}:{tag[1]}:{tag[2]} q90, restart 3",
                    lambda p, img=img, samp=samp: save_cv2(p, img, samp, 90,
                                                           restart=3)))
    img = texture(rng, 61, 97)
    out.append(("pil_420_optimize_97x61.jpg", "PIL 4:2:0 q90 optimize",
                lambda p: save_pil(p, img, quality=90, optimize=True)))
    img2 = texture(rng, 129, 257)
    out.append(("pil_420_restart_257x129.jpg", "PIL 4:2:0 q90 restart 2",
                lambda p: save_pil(p, img2, quality=90,
                                   restart_marker_blocks=2)))
    for (h, w) in ((1, 1), (61, 97)):
        g = texture(rng, h, w, 1)
        out.append((f"gray_{w}x{h}.jpg", "PIL gray q90",
                    lambda p, g=g: save_pil(p, g, quality=90)))
    img3 = texture(rng, 61, 97)
    out.append(("adobe_rgb_97x61.jpg", "PIL RGB (Adobe, keep_rgb) q90",
                lambda p: save_pil(p, img3, quality=90, keep_rgb=True)))
    for o in (6, 8):
        img4 = texture(rng, 40, 64)
        out.append((f"exif_gps_orientation{o}_64x40.jpg",
                    f"PIL 4:2:0 q90, EXIF GPS and orientation {o}",
                    lambda p, img4=img4, o=o: save_pil(
                        p, img4, quality=90, exif=exif_bytes(o))))
    img5 = texture(rng, 61, 97)
    tables = [list(range(256, 320)), list(range(300, 364))]
    out.append(("dqt16_sof1_97x61.jpg", "PIL 16-bit DQT (SOF1)",
                lambda p: save_pil(p, img5, qtables=tables)))
    img6 = texture(rng, 61, 97)
    out.append(("progressive_97x61.jpg", "PIL progressive q90",
                lambda p: save_pil(p, img6, quality=90, progressive=True)))
    view = texture(rng, 900, 1600, noise=6.0)
    out.append(("view_420_1600x900.jpg", "PIL 4:2:0 q90, a 1600x900 view",
                lambda p: save_pil(p, view, quality=90)))
    # progressive (SOF2)
    for (h, w), sub, q in (((17, 13), 0, 90), ((97, 61), 1, 75),
                           ((1, 1), 2, 90), ((129, 257), 2, 50)):
        name = (f"progressive_pil_{('444', '422', '420')[sub]}_q{q}_"
                f"{w}x{h}.jpg")
        pimg = texture(rng, h, w)
        out.append((name, f"PIL progressive "
                    f"{('4:4:4', '4:2:2', '4:2:0')[sub]} q{q}",
                    lambda p, pimg=pimg, sub=sub, q=q: save_pil(
                        p, pimg, quality=q, subsampling=sub,
                        progressive=True)))
    g = texture(rng, 17, 13, 1)
    out.append(("progressive_gray_13x17.jpg", "PIL progressive gray q90",
                lambda p: save_pil(p, g, quality=90, progressive=True)))
    for (h, w), samp, tag in (((61, 97), s411, "411"),
                              ((97, 61), s440, "440")):
        pimg = texture(rng, h, w)
        out.append((f"progressive_cv2_{tag}_rst_{w}x{h}.jpg",
                    f"OpenCV progressive {tag[0]}:{tag[1]}:{tag[2]} q90, "
                    "restart 3",
                    lambda p, pimg=pimg, samp=samp: save_cv2(
                        p, pimg, samp, 90, restart=3, progressive=True)))
    img7 = texture(rng, 61, 97)
    out.append(("progressive_pil_420_restart_97x61.jpg",
                "PIL progressive 4:2:0 q90 restart 2",
                lambda p: save_pil(p, img7, quality=90, progressive=True,
                                   restart_marker_blocks=2)))
    img8 = texture(rng, 97, 61)
    out.append(("progressive_pil_420_optimize_61x97.jpg",
                "PIL progressive 4:2:0 q90 optimize",
                lambda p: save_pil(p, img8, quality=90, progressive=True,
                                   optimize=True)))
    out.append(("view_420_1600x900_progressive.jpg",
                "PIL progressive 4:2:0 q90, the 1600x900 view's twin",
                lambda p: save_pil(p, view, quality=90, progressive=True)))
    img9 = texture(rng, 61, 97)
    out.append(("progressive_incomplete_97x61.jpg",
                "PIL progressive 4:2:0 q90 cut after its DC scan, refused",
                lambda p: save_dc_only(p, img9)))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(2026)
    manifest = {}
    for name, kind, write in fixtures(rng):
        path = os.path.join(args.out, name)
        write(path)
        with Image.open(path) as im:
            pil = np.asarray(im)
        entry = {"kind": kind, "shape": list(pil.shape),
                 "pil_sha256": digest(pil),
                 "progressive": "progressive" in kind,
                 "refused": "refused" in kind}
        if not entry["refused"]:
            entry["encoded_sha256"] = encoded_digests(pil)
        bgr = cv2.imread(path)
        same = (pil[..., ::-1] if pil.ndim == 3
                else np.repeat(pil[..., None], 3, -1))
        if bgr.shape != same.shape or not np.array_equal(bgr, same):
            entry["cv2_shape"] = list(bgr.shape)
            entry["cv2_bgr_sha256"] = digest(bgr)
        manifest[name] = entry
    twin = manifest["view_420_1600x900_progressive.jpg"]["pil_sha256"]
    assert twin == manifest["view_420_1600x900.jpg"]["pil_sha256"]
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, n)) for n in manifest)
    print(f"{len(manifest)} fixtures, {total} bytes -> {args.out}")


if __name__ == "__main__":
    main()
