"""The serving cells: ``viewer/service.serve`` on a merged hierarchy,
driven over its socket by one closed-loop remote viewer in its own
process (``core/client.py``).

Set-up builds the hierarchy from the seed on the device and hands it to
``HierarchyRenderer`` by replacing ``viewer.service.read_hier`` (the
``.hier`` file would be ~1.3 GB); the viewer's budget is the upstream
default given in MB. The client warms up, then requests frames along the
traffic's camera path, each when the last one has arrived, for the
window's seconds. Frames at request indices drawn from the seed are kept
and checked against the plain reference after the window.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import torch

from benchmark.core.observe import Patches
from benchmark.gen import hierarchy as ghier
from benchmark.gen import scene as gen
from benchmark.reference import camera as rcam
from benchmark.reference import serve as rserve

CLIENT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "core", "client.py")


def budget_splats(cfg: dict, n_nodes: int) -> int:
    """The viewer's splat budget for its MB budget (the reference
    viewer's 660 bytes a splat), at most the hierarchy's node count."""
    return min(max(int(cfg["budget_mb"] * (1 << 20) / 660), 1 << 10),
               n_nodes)


def make_hierarchy(cfg: dict, seed: int, device) -> dict:
    g = gen.generator(seed, device)
    phases = gen.texture_phases(g, device)
    half = cfg["chunk_half"]
    parts, orders = [], []
    base = 0
    for c in range(cfg["chunks"]):
        cx = (c - (cfg["chunks"] - 1) / 2.0) * 2 * half
        leaves = gen.surface_gaussians(cfg["gaussians_per_chunk"], cx, half,
                                       phases, g, device, cfg["color_noise"],
                                       cfg["pos_noise"], cfg["rest_std"])
        parts.append(leaves)
        orders.append(ghier.morton_order(leaves["xyz"]) + base)
        base += cfg["gaussians_per_chunk"]
    leaves = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return ghier.build_hierarchy(leaves, torch.cat(orders))


# ------------------------------------------------------------ camera paths --
def _walk_point(s: float, cfg: dict, traffic: dict):
    w = cfg["chunks"] * cfg["chunk_half"]
    x = 0.75 * w * math.sin(2 * math.pi * s)
    z = 0.66 * cfg["chunk_half"] * math.sin(4 * math.pi * s)
    low, high = traffic["walk_low"], traffic["walk_high"]
    h = low + (high - low) * math.sin(2 * math.pi * s) ** 2
    return x, z, h


def walk_poses(cfg: dict, traffic: dict):
    """A closed fly-through (a figure eight) that climbs to whole-scene
    views at ``walk_high`` and sinks to one-chunk views at ``walk_low``;
    each frame moves by at least ``walk_step`` x its height, so no frame
    can reuse the last cut."""
    low, high = traffic["walk_low"], traffic["walk_high"]
    grid = np.linspace(0.0, 1.0, 20001)
    pts = np.array([_walk_point(s, cfg, traffic) for s in grid])
    xyz = np.stack([pts[:, 0], -pts[:, 2], pts[:, 1]], 1)
    seg = np.linalg.norm(np.diff(xyz, axis=0), axis=1)
    effort = np.concatenate([[0], np.cumsum(seg / (traffic["walk_step"]
                                                   * pts[:-1, 2]))])
    n = int(effort[-1])
    marks = np.searchsorted(effort, np.arange(n) * effort[-1] / n)
    poses = []
    for k in marks:
        x, z, h = pts[k]
        x2, z2, _ = pts[min(k + 40, len(grid) - 1)]
        d = np.array([x2 - x, z2 - z])
        d /= max(np.linalg.norm(d), 1e-9)
        a = (h - low) / (high - low)
        ahead = np.array([x + 2.5 * d[0], 0.0, z + 2.5 * d[1]])
        target = (1 - a) * ahead
        poses.append(((x, -h, z), tuple(target)))
    return poses


def look_poses(traffic: dict):
    """Standing at ``eye`` (the walk's lowest point, where the chunks
    meet), turning: yaw within +-``yaw_deg`` and pitch within
    +-``pitch_deg`` of the view towards ``target``. Every seed stands at
    the same place (the seed picks where in the turn the window starts),
    so every seed gets the same work."""
    eye = np.array(traffic["eye"], dtype=np.float64)
    fwd = np.array(traffic["target"], dtype=np.float64) - eye
    yaw0 = math.atan2(fwd[0], fwd[2])
    pitch0 = math.atan2(fwd[1], math.hypot(fwd[0], fwd[2]))
    poses = []
    n = traffic["turn_frames"]
    for i in range(n):
        yaw = yaw0 + math.radians(traffic["yaw_deg"]) * math.sin(
            2 * math.pi * i / n)
        pitch = pitch0 + math.radians(traffic["pitch_deg"]) * math.sin(
            2 * math.pi * 3 * i / n)
        d = np.array([math.sin(yaw) * math.cos(pitch), math.sin(pitch),
                      math.cos(yaw) * math.cos(pitch)])
        poses.append((tuple(eye), tuple(eye + d)))
    return poses


def poses_for(ctx):
    if ctx.traffic["path"] == "walk":
        return walk_poses(ctx.config, ctx.traffic)
    return look_poses(ctx.traffic)


def camera_of(pose, cfg: dict):
    w, h = cfg["width"], cfg["height"]
    fovx = cfg["fov_x"]
    fovy = rcam.fovy_of(fovx, w, h)
    rows, t = rcam.look_at(*pose)
    return rows, t, fovx, fovy


def request_body(pose, cfg: dict) -> str:
    """network_gui request for a pose: the wire carries transposed
    matrices with the view's Y and Z and the projection's Y columns
    negated."""
    rows, t, fovx, fovy = camera_of(pose, cfg)
    view, full, _ = rcam.matrices(rows, t, fovx, fovy)
    v = view.T.copy()
    v[:, 1] = -v[:, 1]
    v[:, 2] = -v[:, 2]
    p = full.T.copy()
    p[:, 1] = -p[:, 1]
    return json.dumps({
        "resolution_x": cfg["width"], "resolution_y": cfg["height"],
        "train": True, "fov_y": fovy, "fov_x": fovx, "z_near": 0.01,
        "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": False, "scaling_modifier": 1.0,
        "view_matrix": [float(x) for x in v.reshape(-1)],
        "view_projection_matrix": [float(x) for x in p.reshape(-1)]})


def sample_indices(ctx) -> list:
    """One request index per block of ``check_every``, from the seed."""
    rng = np.random.default_rng(ctx.seed)
    every = ctx.traffic["check_every"]
    return [int(b * every + rng.integers(every)) for b in range(200)]


# ---------------------------------------------------------------- the run --
def run(ctx) -> dict:
    from h3dgs_tpu_torch.hierarchy import cut as cut_mod
    from h3dgs_tpu_torch.hierarchy.tree import Hierarchy
    from h3dgs_tpu_torch.train import post_step as post_mod
    from h3dgs_tpu_torch.viewer import service
    from h3dgs_tpu_torch.viewer.network_gui import NetworkGUI

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    hier = make_hierarchy(cfg, ctx.seed, dev)
    host = Hierarchy(**{k: v.cpu().numpy() for k, v in hier.items()},
                     anchors=np.zeros(0, np.int32))
    n_nodes = host.n_nodes
    del hier
    poses = poses_for(ctx)
    start = int(np.random.default_rng(ctx.seed + 1).integers(len(poses)))
    keep = sample_indices(ctx)
    keep_set = set(keep)
    # Per frame, the render's reported cut size and reuse flag, kept as
    # plain ints (no objects for the collector to walk while timing).
    cut_sizes, reused = [], []

    with Patches() as pt:
        pt.set(service, "read_hier", lambda _path: host)
        renderer = service.HierarchyRenderer(
            "seeded-hierarchy", budget=budget_splats(cfg, n_nodes),
            sh_degree=cfg["sh_degree"], device=dev)
    del host
    stop = threading.Event()
    port = ctx.free_port()
    flags = {"go": False, "n_warm": None}
    errors = []
    render_of = renderer.render

    def render(camera, tau):
        # Runs on the serving thread: the window (and the profiler, whose
        # ranges are recorded per thread) opens at the client's last
        # warm-up request, before the client starts its clock.
        # A frame the check compares renders inside ``bench.serve.checked``
        # too, so K1's roofline reads the time of the frames whose work
        # the reference counted.
        if flags["go"] and flags["n_warm"] is None:
            flags["n_warm"] = len(cut_sizes) + 1
            ctx.window_started()
        checked = (flags["n_warm"] is not None
                   and len(cut_sizes) - flags["n_warm"] in keep_set)
        with torch.profiler.record_function("bench.serve.render"):
            if checked:
                with torch.profiler.record_function("bench.serve.checked"):
                    out = render_of(camera, tau)
            else:
                out = render_of(camera, tau)
        cut_sizes.append(int(out[1]["cut_size"]))
        reused.append(int(out[1]["cut_reused"]))
        return out

    job = {"port": port, "width": cfg["width"], "height": cfg["height"],
           "bodies": [request_body(p, cfg) for p in poses],
           "warmup": traffic["warmup"], "seconds": ctx.seconds,
           "start": start, "keep": keep,
           "out": os.path.join(ctx.tmp, "client.out")}
    job_path = os.path.join(ctx.tmp, "client.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    client = subprocess.Popen([sys.executable, CLIENT, job_path],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True)

    def drive():
        try:
            line = client.stdout.readline().strip()
            if line != "ready":
                raise RuntimeError(f"client did not warm up ({line!r})")
            flags["go"] = True
            client.stdin.write("arm\n")
            client.stdin.flush()
            line = client.stdout.readline().strip()
            if line != "done":
                raise RuntimeError(f"client ended early ({line!r})")
            client.stdin.write("bye\n")
            client.stdin.flush()
            if client.wait(timeout=120) != 0:
                raise RuntimeError(f"client failed ({client.returncode})")
        except Exception as e:  # reported by the serving thread below
            errors.append(e)
        finally:
            if client.poll() is None:
                client.kill()
                client.wait()
            stop.set()

    with Patches() as pt:
        pt.set(renderer, "render", render)
        pt.ranged(renderer, "_fit_limit", "serve.fit_limit")
        pt.ranged(cut_mod, "expand_to_size", "serve.expand")
        pt.ranged(cut_mod, "interpolate_cut", "serve.interpolate")
        pt.ranged(post_mod, "rasterize", "serve.rasterize")
        pt.ranged(NetworkGUI, "_send", "serve.send")
        helper = threading.Thread(target=drive, daemon=True)
        helper.start()
        try:
            service.serve(renderer, "127.0.0.1", port, cfg["tau"], stop=stop)
        finally:
            stop.set()
            helper.join(timeout=ctx.seconds + 300)
    if errors:
        raise errors[0]
    if flags["n_warm"] is None:
        raise RuntimeError("no request reached the window")
    n_warm = flags["n_warm"]
    ctx.window_closed()
    with open(job["out"], "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        head = json.loads(f.read(n))
        size = cfg["width"] * cfg["height"] * 3
        frames = {i: np.frombuffer(f.read(size), np.uint8).reshape(
            cfg["height"], cfg["width"], 3).copy() for i in head["kept"]}
    del renderer
    return dict(latency_s=head["latency_s"], window_s=head["window_s"],
                frames=frames, poses=poses, start=start,
                reused=sum(reused[n_warm:]), rendered=len(reused) - n_warm,
                cut_sizes=cut_sizes[n_warm:])


# --------------------------------------------------------------- the check --
def reference_check(ctx, res: dict, dtype=torch.float32, alter=None) -> dict:
    """Each kept frame against the reference's frame of its request:
    the share of pixels off by more than 2 levels in any channel, and the
    mean absolute difference in levels; the worst frame of each."""
    cfg, dev = ctx.config, ctx.device
    hier = make_hierarchy(cfg, ctx.seed, dev)
    budget = budget_splats(cfg, hier["nodes"].shape[0])
    poses = res["poses"]
    worst_share = worst_mad = 0.0
    work = []
    for i, got in sorted(res["frames"].items()):
        pose = poses[(res["start"] + i) % len(poses)]
        rows, t, fovx, fovy = camera_of(pose, cfg)
        cam = rcam.make_cam(rows, t, fovx, fovy, cfg["width"],
                            cfg["height"], dev)
        want, counts = rserve.frame(hier, cam, cfg["tau"], budget, dtype)
        got_t = torch.as_tensor(got, device=dev)
        if alter is not None:
            got_t = alter(i, got_t)
        diff = (got_t.int() - want.int()).abs()
        share = float((diff.amax(dim=-1) > 2).float().mean())
        mad = float(diff.float().mean())
        worst_share = max(worst_share, share)
        worst_mad = max(worst_mad, mad)
        work.append(dict(counts, nodes=int(hier["nodes"].shape[0]),
                         pixels=cfg["width"] * cfg["height"]))
    return {"frames_checked": len(res["frames"]),
            "bad_pixel_share": worst_share, "mean_abs_levels": worst_mad,
            "work": work}


# ------------------------------------------------------- what is compared --
def compared_numbers(res: dict, check: dict) -> dict:
    if not check["frames_checked"]:
        return {}
    return {"bad_pixel_share": check["bad_pixel_share"],
            "mean_abs_levels": check["mean_abs_levels"]}


def attempted(res: dict) -> int:
    return len(res["latency_s"])


def failed(res: dict) -> int:
    return 0


# ------------------------------------------------------------- control --
def control(ctx) -> dict:
    """The compared numbers with the reference computed in bfloat16 put
    in the program's place, against the float32 reference, on the frames
    a run would check (at a 30 s window's request count)."""
    cfg, dev = ctx.config, ctx.device
    poses = poses_for(ctx)
    start = int(np.random.default_rng(ctx.seed + 1).integers(len(poses)))
    hier = make_hierarchy(cfg, ctx.seed, dev)
    budget = budget_splats(cfg, hier["nodes"].shape[0])
    frames = {}
    for i in sample_indices(ctx)[:ctx.traffic.get("control_frames", 8)]:
        rows, t, fovx, fovy = camera_of(poses[(start + i) % len(poses)],
                                        cfg)
        cam = rcam.make_cam(rows, t, fovx, fovy, cfg["width"],
                            cfg["height"], dev)
        frames[i] = rserve.frame(hier, cam, cfg["tau"], budget,
                                 torch.bfloat16)[0].cpu().numpy()
    del hier
    res = {"frames": frames, "poses": poses, "start": start}
    return {"control_bf16": compared_numbers(res, reference_check(ctx,
                                                                  res))}
