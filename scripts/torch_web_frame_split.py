#!/usr/bin/env python3
"""Where a browser-viewer frame's time goes, on one CUDA card.

Builds the serving scene of ``chip_smoke.py`` (its seeded 1,000,000-leaf
hierarchy, ``HierarchyRenderer(budget=1 << 20)``) and serves it with
``WebViewer``. For each of ``--poses`` poses on an orbit at 1920x1080 and
tau 3 it times, on the host clock and in this order: one ``/frame``
request at a new pose (fresh cut: render + JPEG encode + transfer, the
client's view), ``renderer.render`` at another new pose (fresh cut),
``renderer.render`` at that pose again (cached cut), ``encode_jpeg`` of
that frame at q 85, and ``encode_jpeg`` of the same pixels in a strided
array (as ``permute`` leaves a tensor; the encoder first copies it into
row order). Prints the medians and each list, with the card's name and
power limit.

Run: python3 scripts/torch_web_frame_split.py [--poses 10]
(from the repository root, on a machine with one CUDA card)
"""
from __future__ import annotations

import argparse
import http.client
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--poses", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_web_frame_split: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from h3dgs_tpu_torch.hierarchy.io import write_hier
    from h3dgs_tpu_torch.hierarchy.tree import build_hierarchy
    from h3dgs_tpu_torch.io.jpeg_encode import encode_jpeg
    from h3dgs_tpu_torch.scene.camera import look_at_camera
    from h3dgs_tpu_torch.viewer.service import HierarchyRenderer
    from h3dgs_tpu_torch.viewer.web import WebViewer

    card = chip_smoke.card_line()
    h = build_hierarchy(*chip_smoke.make_scene(np.random.default_rng(0),
                                               chip_smoke.N_LEAVES))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "merged.hier")
        write_hier(path, h)
        renderer = HierarchyRenderer(path, budget=chip_smoke.BUDGET,
                                     device="cuda")
    viewer = WebViewer(renderer, port=0, tau=3.0).start()
    w, hh, tau = chip_smoke.WIDTH, chip_smoke.HEIGHT, 3.0
    c = viewer.center
    times = {k: [] for k in ("request", "render fresh", "render cached",
                             "encode", "encode strided")}

    def eye_at(a):
        return (c[0] + 5 * np.sin(a), c[1] - 2.0, c[2] - 5 * np.cos(a))

    try:
        conn = http.client.HTTPConnection("127.0.0.1", viewer.port,
                                          timeout=120)
        for i in range(args.poses + 1):         # the first is a warm-up
            a = 2 * np.pi * i / (args.poses + 1)
            e = eye_at(a)
            url = (f"/frame?ex={e[0]}&ey={e[1]}&ez={e[2]}&tx={c[0]}"
                   f"&ty={c[1]}&tz={c[2]}&fovx=1.2&w={w}&h={hh}&tau={tau}")
            t0 = time.perf_counter()
            conn.request("GET", url)
            resp = conn.getresponse()
            body = resp.read()
            t_req = time.perf_counter() - t0
            assert resp.status == 200 and body[:2] == b"\xff\xd8"
            cam = look_at_camera(eye=eye_at(a + 0.1), target=tuple(c),
                                 fovx=1.2, width=w, height=hh)
            t0 = time.perf_counter()
            img, _ = renderer.render(cam, tau)
            t_fresh = time.perf_counter() - t0
            t0 = time.perf_counter()
            img, _ = renderer.render(cam, tau)
            t_cached = time.perf_counter() - t0
            t0 = time.perf_counter()
            encode_jpeg(img, 85)
            t_enc = time.perf_counter() - t0
            strided = np.ascontiguousarray(img.transpose(2, 0, 1)).transpose(
                1, 2, 0)
            t0 = time.perf_counter()
            encode_jpeg(strided, 85)
            t_str = time.perf_counter() - t0
            if i:
                for k, t in zip(times, (t_req, t_fresh, t_cached, t_enc,
                                        t_str)):
                    times[k].append(1e3 * t)
        conn.close()
    finally:
        viewer.stop()
    print(f"{card}; {w}x{hh}, tau {tau}, q 85, {args.poses} poses, host "
          "clock, ms:")
    for k, v in times.items():
        print(f"  {k}: median {np.median(v):.2f} "
              f"({', '.join(f'{x:.1f}' for x in v)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
