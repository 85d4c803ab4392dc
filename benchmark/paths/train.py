"""The per-chunk training cell: ``cli/train_single.main`` resumed at a
mid-run iteration, timed over its own loop.

Set-up writes the chunk's dataset (views as baseline JPEG, inverse
depths as 16-bit PNG, the COLMAP model, the degree-1 scaffold with its
locked sky, the chunk bounds) into the run's temporary directory and
starts the CLI with
``--start_checkpoint``; ``train.checkpoint.load_flat`` is replaced by one
that hands the loop a seeded mid-run state (8.1M rows, Adam moments,
densification statistics, exposures) in memory, since that file would be
~5.7 GB. The first ``checked_steps`` steps are recorded for the check
(and, with ``--trace 1``, traced for K2's roofline); after
``warmup_steps`` the window opens, and it closes at the first step that
ends ``seconds`` later. A densify pass falls inside it.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from benchmark.core import files, jpeg
from benchmark.core.observe import Patches, StopWindow, ranged_factory
from benchmark.gen import scene as gen
from benchmark.reference import camera as rcam
from benchmark.reference import jpeg as rjpeg
from benchmark.reference import train as rtrain

LEAVES = rtrain.LEAVES
STATE_KEY = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
             "opacity": "opacity", "scaling": "scaling",
             "rotation": "rotation"}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- inputs ---
def view_cameras(cfg: dict):
    """The chunk's views: a ring around the chunk, the same for every
    seed (the seed changes the scene, not the work)."""
    w, h, fovx = cfg["width"], cfg["height"], cfg["fov_x"]
    fovy = rcam.fovy_of(fovx, w, h)
    cams = []
    n = cfg["views"]
    for i in range(n):
        a = 2 * math.pi * i / n
        r = cfg["ring_radius"] * (1.0 + 0.08 * math.sin(5 * a))
        height = cfg["ring_height"] * (1.0 + 0.25 * math.cos(3 * a))
        eye = (r * math.sin(a), -height, -r * math.cos(a))
        target = (0.6 * math.sin(7 * a), 0.0, 0.6 * math.cos(4 * a))
        rows, t = rcam.look_at(eye, target)
        fx = w / (2.0 * math.tan(fovx / 2.0))
        fy = h / (2.0 * math.tan(fovy / 2.0))
        cams.append(dict(rows=rows, t=t, eye=list(eye), width=w, height=h,
                         fovx=2.0 * math.atan(w / (2.0 * fx)),
                         fovy=2.0 * math.atan(h / (2.0 * fy)), fx=fx, fy=fy,
                         tanfovx=math.tan(fovx / 2.0),
                         tanfovy=math.tan(fovy / 2.0),
                         name=f"view_{i:04d}.jpg"))
    return cams


def make_inputs(cfg: dict, seed: int, device):
    """Everything the cell is made of, from the seed: the views' pixels
    and inverse depths, the scaffold, and the mid-run state."""
    g = gen.generator(seed, device)
    phases = gen.texture_phases(g, device)
    half = cfg["chunk_half"]
    cams = view_cameras(cfg)
    imgs, invd = gen.raycast_views(cams, phases, half, [0.0], device)
    n, n_sky, n_sc = cfg["gaussians"], cfg["skybox"], cfg["scaffold"]
    surf = gen.surface_gaussians(n, 0.0, half, phases, g, device,
                                 cfg["color_noise"], cfg["pos_noise"],
                                 cfg["rest_std"])
    # Scaffold: the sky on a far sphere, then a ring above the cameras,
    # outside the chunk's box and out of every view (where neighbouring
    # chunks' Gaussians would be).
    theta = torch.rand(n_sky, generator=g, device=device) * 2 * math.pi
    phi = torch.arccos(1.0 - 1.4 * torch.rand(n_sky, generator=g,
                                              device=device))
    sky_xyz = 40.0 * torch.stack([torch.cos(theta) * torch.sin(phi),
                                  -torch.cos(phi),
                                  torch.sin(theta) * torch.sin(phi)], 1)
    ring = n_sc - n_sky
    ext = cfg["chunk_half"]
    u = torch.rand((ring, 3), generator=g, device=device)
    ring_xyz = torch.stack([(u[:, 0] - 0.5) * 0.9 * ext,
                            -(1.1 + 0.6 * u[:, 1]) * ext,
                            (u[:, 2] - 0.5) * 0.9 * ext], 1)
    sc_rgb = torch.cat([torch.tensor(gen.SKY_RGB, device=device).expand(
        n_sky, 3), 0.1 + 0.8 * torch.rand((ring, 3), generator=g,
                                          device=device)])
    sc_rest = torch.randn((n_sc, 3, 3), generator=g, device=device) * 0.02
    return dict(phases=phases, cams=cams, imgs=imgs, invd=invd, surf=surf,
                sc_xyz=torch.cat([sky_xyz, ring_xyz]), sc_rgb=sc_rgb,
                sc_rest=sc_rest, gen=g)


def midrun_state(cfg: dict, inp: dict, start_it: int, device):
    """The seeded state at iteration ``start_it``: rows [sky | ring |
    surface | free], activations' inputs as the optimizer holds them,
    Adam moments of the live rows, densification statistics gathered
    since the last densify pass, one exposure per view."""
    g = inp["gen"]
    n, n_sky, n_sc = cfg["gaussians"], cfg["skybox"], cfg["scaffold"]
    cap = n_sc + int(n * cfg["capacity_factor"])
    surf = inp["surf"]
    sc = slice(0, n_sc)
    body = slice(n_sc, n_sc + n)

    def zeros(*shape):
        return torch.zeros((cap,) + shape, device=device)

    st = {"xyz": zeros(3), "f_dc": zeros(1, 3), "f_rest": zeros(15, 3),
          "opacity": zeros(1), "scaling": zeros(3), "rotation": zeros(4)}
    st["xyz"][sc] = inp["sc_xyz"]
    st["xyz"][body] = surf["xyz"]
    st["f_dc"][sc, 0] = (inp["sc_rgb"] - 0.5) / gen.SH_C0
    st["f_rest"][sc, :3] = inp["sc_rest"]
    st["f_dc"][body] = surf["sh"][:, :1]
    st["f_rest"][body] = surf["sh"][:, 1:]
    st["opacity"][sc] = 1.0
    lo, hi = cfg["opacity_logit"]
    st["opacity"][body, 0] = lo + (hi - lo) * torch.rand(
        n, generator=g, device=device)
    st["scaling"][:n_sky] = math.log(1.5)
    st["scaling"][n_sky:n_sc] = math.log(0.02)
    st["scaling"][body] = surf["scaling"]
    st["rotation"][:, 0] = 1.0
    st["rotation"][body] = surf["rotation"]
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n_sc + n] = True

    mu, nu = {}, {}
    for k in LEAVES:
        s = cfg["adam_scale"][k]
        mu[k] = torch.zeros_like(st[k])
        nu[k] = torch.zeros_like(st[k])
        shape = (n,) + tuple(st[k].shape[1:])
        mu[k][body] = s * torch.randn(shape, generator=g, device=device)
        nu[k][body] = (s * s) * (0.5 + torch.rand(shape, generator=g,
                                                  device=device))
    v = cfg["views"]
    exposure = torch.eye(3, 4, device=device).repeat(v, 1, 1) + 0.01 * \
        torch.randn((v, 3, 4), generator=g, device=device)
    mu["exposure"] = 1e-4 * torch.randn((v, 3, 4), generator=g, device=device)
    nu["exposure"] = 1e-8 * (0.5 + torch.rand((v, 3, 4), generator=g,
                                              device=device))
    accum, radii, denom = (torch.zeros(cap, device=device) for _ in range(3))
    accum[body] = cfg["accum_scale"] * torch.rand(n, generator=g,
                                                  device=device)
    radii[body] = torch.floor(8.0 * torch.rand(n, generator=g,
                                               device=device))
    denom[body] = torch.floor(40.0 * torch.rand(n, generator=g,
                                                device=device))
    return dict(st, alive=alive, exposure=exposure, mu=mu, nu=nu,
                step=start_it, accum=accum, denom=denom, radii=radii)


def write_dataset(root: str, cfg: dict, inp: dict) -> None:
    """The chunk's files, as the upstream pipeline lays them out."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "depths"), exist_ok=True)
    raw = (inp["invd"] * 65536.0).clamp(0, 65535).to(torch.int32)
    raw = raw.cpu().numpy().astype(np.uint16)
    items = []
    for i, c in enumerate(inp["cams"]):
        with open(os.path.join(root, "images", c["name"]), "wb") as f:
            f.write(jpeg.jpeg_bytes(inp["imgs"][i], cfg["jpeg_quality"]))
        items.append((os.path.join(root, "depths", c["name"][:-4] + ".png"),
                      raw[i]))
    files.write_pngs(items)
    files.write_json(os.path.join(sparse, "depth_params.json"),
                     {c["name"][:-4]: {"scale": 1.0, "offset": 0.0}
                      for c in inp["cams"]})
    # points3D: a sample of the surface (the resumed state replaces what
    # the scene initialises from it).
    k = cfg["points3d"]
    pts = inp["surf"]["xyz"][:k].double().cpu().numpy()
    rgb = (inp["surf"]["rgb"][:k] * 255 + 0.5).to(torch.uint8).cpu().numpy()
    files.write_colmap(sparse, inp["cams"], pts, rgb)
    sc_dir = os.path.join(root, "scaffold")
    n_sc = cfg["scaffold"]
    sc_dc = ((inp["sc_rgb"] - 0.5) / gen.SH_C0).cpu().numpy()
    rot = np.zeros((n_sc, 4), np.float32)
    rot[:, 0] = 1
    scl = np.full((n_sc, 3), math.log(0.02), np.float32)
    scl[:cfg["skybox"]] = math.log(1.5)
    files.write_gaussian_ply(
        os.path.join(sc_dir, "point_cloud.ply"),
        inp["sc_xyz"].cpu().numpy(), sc_dc[:, None, :],
        inp["sc_rest"].cpu().numpy(), np.ones(n_sc, np.float32), scl, rot)
    files.write_text(os.path.join(sc_dir, "pc_info.txt"),
                     f"{cfg['skybox']}\n")
    files.write_text(os.path.join(root, "center.txt"), "0.0 0.0 0.0\n")
    e = 2.0 * cfg["chunk_half"]
    files.write_text(os.path.join(root, "extent.txt"), f"{e} {e} {e}\n")


def scene_extent(cams) -> float:
    """The scene's spatial scale: 1.1 x the 90th percentile of the view
    centres' distances from their mean (the upstream NeRF++ radius)."""
    c = np.array([c["eye"] for c in cams])
    d = np.linalg.norm(c - c.mean(axis=0), axis=1)
    return float(np.quantile(d, 0.9) * 1.1)


def reference_views(inp: dict, device, quality: int) -> "_Views":
    """Each view as both sides receive it, made when asked for: the
    pixels decoded from the JPEG's coefficients / 255, inverse depth as
    read from the 16-bit PNG and sent as float16."""
    return _Views(inp, device, quality)


class _Views:

    def __init__(self, inp: dict, device, quality: int):
        self.imgs, self.invd, self.cams = inp["imgs"], inp["invd"], inp["cams"]
        self.device, self.quality = device, quality

    def __getitem__(self, i: int) -> dict:
        c, dev = self.cams[i], self.device
        raw = (self.invd[i] * 65536.0).clamp(0, 65535).to(torch.int32)
        invd = (raw.float() / 65536.0).half().float()
        px = rjpeg.pixels(jpeg.coefficients(self.imgs[i], self.quality))
        return dict(
            index=i,
            cam=rcam.make_cam(np.asarray(c["rows"]), np.asarray(c["t"]),
                              c["fovx"], c["fovy"], c["width"],
                              c["height"], dev),
            gt=px.permute(2, 0, 1).float() / 255.0,
            alpha=torch.ones((1, c["height"], c["width"]), device=dev),
            invdepth=invd[None], depth_mask=torch.ones(
                (1, c["height"], c["width"]), device=dev))


# ---------------------------------------------------------------- the run --
def run(ctx) -> dict:
    """Set up, run the window, free the program, return what the check
    and the readers need."""
    import h3dgs_tpu_torch.parallel.step as dp_mod
    from h3dgs_tpu_torch.cli import train_single
    from h3dgs_tpu_torch.ops.adam import AdamState
    from h3dgs_tpu_torch.train import checkpoint as ckpt_mod
    from h3dgs_tpu_torch.train import loop as loop_mod

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    start_it = traffic["start_iteration"]
    inp = make_inputs(cfg, ctx.seed, dev)
    root = os.path.join(ctx.tmp, "chunk")
    write_dataset(root, cfg, inp)
    hold = [midrun_state(cfg, inp, start_it, dev)]
    del inp
    n_views = cfg["views"]
    rec = {"views": [], "loss": [], "densify": [], "steps": 0}

    def load_flat(_path, template):
        if (template.n_skybox != cfg["skybox"]
                or template.n_scaffold != cfg["scaffold"]
                or template.skybox_last):
            raise RuntimeError(
                f"scene rows differ from the seeded layout: skybox "
                f"{template.n_skybox}, scaffold {template.n_scaffold}")
        s = hold.pop()
        state = dataclasses.replace(
            template, **{STATE_KEY[k]: s[k] for k in LEAVES},
            alive=s["alive"], xyz_gradient_accum=s["accum"],
            denom=s["denom"], max_radii2d=s["radii"])
        step = torch.tensor(s["step"], dtype=torch.int32, device=dev)
        opt = AdamState(mu={k: s["mu"][k] for k in LEAVES},
                        nu={k: s["nu"][k] for k in LEAVES}, step=step)
        exp_opt = AdamState(mu={"exposure": s["mu"]["exposure"]},
                            nu={"exposure": s["nu"]["exposure"]},
                            step=step.clone())
        return state, opt, s["exposure"], exp_opt, start_it

    checked = traffic["checked_steps"]
    warm = traffic["warmup_steps"]
    window = {}

    def next_hook(args, kwargs, out):
        if len(rec["views"]) < checked:
            rec["views"].append([int(h.image_idx) for h in out[0]])
        return out

    def densify_hook(args, kwargs, out):
        if window.get("open") and not rec["densify"]:
            st_in = args[0]
            keep = ("xyz", "scaling", "rotation", "opacity", "alive",
                    "xyz_gradient_accum", "max_radii2d")
            rec["densify"].append({
                "in": {k: getattr(st_in, k) for k in keep},
                "out": {k: getattr(out[0], k)
                        for k in ("xyz", "scaling", "alive")},
                "it": window["it"]})
        return out

    def step_cb(it, out):
        k = it - start_it
        if k <= checked:
            record_checked(k, out)
        if k == checked and checked_prof:
            sync(dev)
            tr = checked_prof.pop().stop()
            rec["k2_checked_s"] = tr.kernel_s("blend_bwd_kernel")
        if k == warm:
            sync(dev)
            ctx.window_started()
            window.update(open=True, t0=time.perf_counter(), it0=it)
        elif k > warm:
            window["it"] = it
            if time.perf_counter() - window["t0"] >= ctx.seconds:
                sync(dev)
                window.update(t1=time.perf_counter(), it1=it, open=False)
                raise StopWindow

    p0 = {k: hold[0][k] for k in LEAVES}
    p0["exposure"] = hold[0]["exposure"]
    mu0 = dict(hold[0]["mu"])
    nu0 = dict(hold[0]["nu"])
    checks = {}

    def record_checked(k, out):
        rec["loss"].append((out.photo_loss + out.depth_loss).float())
        if k == 1:
            mu1 = dict(out.opt.mu, exposure=out.exposure_opt.mu["exposure"])
            nu1 = dict(out.opt.nu, exposure=out.exposure_opt.nu["exposure"])
            norms = {}
            for name in mu1:
                moved = (nu1[name] != nu0[name]).reshape(
                    nu1[name].shape[0], -1).any(dim=1)
                if name == "exposure":
                    moved = torch.ones_like(moved)
                grad = (mu1[name] - 0.9 * mu0[name]) / 0.1
                m = moved.reshape((-1,) + (1,) * (grad.dim() - 1))
                norms[name] = float(torch.where(m, grad, 0.0).norm())
            checks["grad_norms"] = norms
            mu0.clear()
            nu0.clear()
        if k == checked:
            now = dict(out.state.trainable_dict(), exposure=out.exposure)
            checks["change_norms"] = {name: float((now[name] - p0[name]).norm())
                                      for name in p0}
            p0.clear()

    argv = ["-s", root, "-m", os.path.join(ctx.tmp, "model"),
            "--depths", "depths", "--scaffold_file",
            os.path.join(root, "scaffold"), "--bounds_file", root,
            "--skybox_locked", "--disable_viewer",
            "--start_checkpoint", "seeded-midrun-state"]
    for key in ("iterations", "densify_from_iter", "densify_until_iter",
                "densification_interval", "densify_grad_threshold",
                "opacity_reset_interval", "lambda_dssim"):
        argv += [f"--{key}", str(cfg[key])]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    view_grads_of = dp_mod.make_view_grads
    update_of = dp_mod.make_update
    step_of = dp_mod.make_dp_train_step

    orig_train_flat = loop_mod.train_flat

    # With --trace 1 the checked steps are traced too, so that K2's
    # roofline divides their counted work by their own K2 time.
    checked_prof = []

    def train_flat(cfg_, scene, **kw):
        kw["step_cb"] = step_cb
        if ctx.profiler is not None:
            from benchmark.core.trace import Profiler
            checked_prof.append(Profiler(os.path.join(ctx.tmp,
                                                      "checked.json")))
            checked_prof[0].start()
        return orig_train_flat(cfg_, scene, **kw)

    with Patches() as pt:
        pt.set(ckpt_mod, "load_flat", load_flat)
        pt.set(loop_mod, "train_flat", train_flat)
        pt.ranged(loop_mod.BatchedPrefetcher, "__next__", "train.view_next",
                  next_hook)
        pt.ranged(loop_mod, "densify_step", "train.densify", densify_hook)
        pt.set(dp_mod, "make_view_grads",
               ranged_factory(view_grads_of, "train.view_grads"))
        pt.set(dp_mod, "make_update", ranged_factory(update_of,
                                                     "train.update"))
        pt.set(dp_mod, "make_dp_train_step",
               ranged_factory(step_of, "train.step"))
        try:
            train_single.main(argv)
        except StopWindow:
            pass
        else:
            raise RuntimeError("training ended before the window closed")
    ctx.window_closed()
    losses = [float(x) for x in rec["loss"]]
    steps = window["it1"] - window["it0"]
    return dict(window_s=window["t1"] - window["t0"], steps=steps,
                first_it=window["it0"], last_it=window["it1"],
                losses=losses, checks=checks, views=rec["views"],
                densify=rec["densify"], n_views=n_views,
                k2_checked_s=rec.get("k2_checked_s"))


# --------------------------------------------------------------- the check --
def reference_check(ctx, res: dict, dtype=torch.float32, half=False) -> dict:
    """Follow the first checked steps with the plain reference from the
    same seeded inputs, and the window's densify pass from the program's
    own state at that iteration. Returns the compared numbers and the
    work counts."""
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    start_it = traffic["start_iteration"]
    inp = make_inputs(cfg, ctx.seed, dev)
    st = midrun_state(cfg, inp, start_it, dev)
    views = reference_views(inp, dev, cfg["jpeg_quality"])
    extent = scene_extent(inp["cams"])

    def cast(st):
        out = dict(st)
        for k in LEAVES + ("exposure", "accum", "denom", "radii"):
            out[k] = st[k].to(dtype)
        out["mu"] = {k: v.to(dtype) for k, v in st["mu"].items()}
        out["nu"] = {k: v.to(dtype) for k, v in st["nu"].items()}
        return out

    st = cast(st)
    bg = torch.zeros(3, device=dev, dtype=dtype)
    p0 = {k: st[k] for k in LEAVES + ("exposure",)}
    losses, work = [], []
    grad_norms = change_norms = None
    for k, idx in enumerate(res["views"]):
        record = {}
        st = rtrain.train_step(st, views[idx[0]], start_it + k + 1, bg,
                               extent, cfg["skybox"], cfg["scaffold"],
                               record, half=half)
        losses.append(record["photo"] + record["depth"])
        work.append({"k1_pairs": record["k1_pairs"],
                     "k2_pairs": record["k2_pairs"],
                     "k2_contrib": record["k2_contrib"],
                     "visible": record["visible"],
                     "entries": record["entries"],
                     "pixels": cfg["width"] * cfg["height"],
                     "live": int(st["alive"].sum())})
        if k == 0:
            grad_norms = {name: float(g.float().norm())
                          for name, g in record["grads"].items()}
    change_norms = {k: float((st[k] - p0[k]).float().norm()) for k in p0}
    del st, p0
    out = {"losses": losses, "grad_norms": grad_norms,
           "change_norms": change_norms, "work": work}
    if res.get("densify"):
        out["densify"] = densify_check(res["densify"][0], cfg, extent, dtype)
    return out


def densify_check(d: dict, cfg: dict, extent: float, dtype) -> dict:
    """The window's first densify pass, redone by the reference from the
    program's state at that iteration (the split offsets are the standard
    normals of the loop's densification generator, seeded 0)."""
    src = d["in"]
    dev = src["xyz"].device
    c = src["xyz"].shape[0]
    gen_d = torch.Generator(device=dev)
    gen_d.manual_seed(0)
    eps = torch.randn((2, c, 3), generator=gen_d, device=dev,
                      dtype=torch.float32)
    st = {"xyz": src["xyz"].to(dtype), "scaling": src["scaling"].to(dtype),
          "rotation": src["rotation"].to(dtype),
          "opacity": src["opacity"].to(dtype), "alive": src["alive"],
          "accum": src["xyz_gradient_accum"].to(dtype),
          "radii": src["max_radii2d"].to(dtype)}
    ref = rtrain.densify(st, eps.to(dtype), extent, cfg["scaffold"])
    prog = d["out"]
    flips = int((ref["alive"] != prog["alive"]).sum())
    touched = int((ref["alive"] != src["alive"]).sum())
    gaps = {}
    for k in ("xyz", "scaling"):
        dr = float((ref[k].float() - src[k].float()).norm())
        dp = float((prog[k].float() - src[k].float()).norm())
        gaps[k] = abs(dp - dr) / max(dr, 1e-30)
    return {"alive_flips": flips, "touched": touched, "gaps": gaps,
            "n_clone": ref["n_clone"], "n_split": ref["n_split"],
            "n_prune": ref["n_prune"]}


# ------------------------------------------------------- what is compared --
def _norm_gap(prog: dict, ref: dict) -> float:
    """Worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's;
    leaves whose reference norm is under a thousandth of the median are
    rounding and are left out."""
    med = float(np.median(list(ref.values())))
    worst = 0.0
    for k, r in ref.items():
        if r < 1e-3 * med:
            continue
        worst = max(worst, abs(prog[k] - r) / max(r, med))
    return worst


def compared_numbers(res: dict, check: dict) -> dict:
    out = {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(res["losses"], check["losses"])),
        "grad_gap": _norm_gap(res["checks"]["grad_norms"],
                              check["grad_norms"]),
        "change_gap": _norm_gap(res["checks"]["change_norms"],
                                check["change_norms"]),
    }
    d = check.get("densify")
    out["densify_gap"] = None if d is None else max(
        d["alive_flips"] / max(d["touched"], 1), *d["gaps"].values())
    return out


def attempted(res: dict) -> int:
    return res["steps"]


def failed(res: dict) -> int:
    return 0


# ------------------------------------------------- control and faults --
def stream_views(n_views: int, k: int) -> list:
    """The first ``k`` views of the loop's stream (its order is seeded 0,
    one view a step)."""
    idx = np.arange(n_views)
    np.random.default_rng(0).shuffle(idx)
    return [[int(i)] for i in idx[:k]]


def control(ctx) -> dict:
    """The compared numbers with the reference computed in bfloat16 put
    in the program's place (the control), and with the reference that
    leaves out half of each view (a planted fault), both against the
    float32 reference."""
    views = stream_views(ctx.config["views"], ctx.traffic["checked_steps"])
    want = reference_check(ctx, {"views": views})

    def as_program(got):
        return {"losses": got["losses"],
                "checks": {"grad_norms": got["grad_norms"],
                           "change_norms": got["change_norms"]},
                "steps": 0}

    out = {}
    for name, kw in (("control_bf16", {"dtype": torch.bfloat16}),
                     ("fault_half_view", {"half": True})):
        got = reference_check(ctx, {"views": views}, **kw)
        out[name] = compared_numbers(as_program(got), want)
    out["control_bf16"]["densify_gap"] = densify_control(ctx, views)
    return out


def densify_control(ctx, views) -> float:
    """The densify number with a bfloat16 densify pass in the program's
    place, both from the float32 reference's state after the checked
    steps with its statistics scaled so that some rows densify."""
    cfg, dev = ctx.config, ctx.device
    start_it = ctx.traffic["start_iteration"]
    inp = make_inputs(cfg, ctx.seed, dev)
    st = midrun_state(cfg, inp, start_it, dev)
    refs = reference_views(inp, dev, cfg["jpeg_quality"])
    extent = scene_extent(inp["cams"])
    bg = torch.zeros(3, device=dev)
    for k, idx in enumerate(views):
        st = rtrain.train_step(st, refs[idx[0]], start_it + k + 1, bg,
                               extent, cfg["skybox"], cfg["scaffold"], {})
    src = {"xyz": st["xyz"], "scaling": st["scaling"],
           "rotation": st["rotation"], "opacity": st["opacity"],
           "alive": st["alive"], "xyz_gradient_accum": st["accum"] * 10,
           "max_radii2d": st["radii"]}
    c = st["xyz"].shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    eps = torch.randn((2, c, 3), generator=g, device=dev)
    low = rtrain.densify(dict(
        {k: v.to(torch.bfloat16) for k, v in src.items() if k != "alive"},
        alive=src["alive"], accum=(st["accum"] * 10).to(torch.bfloat16),
        radii=st["radii"].to(torch.bfloat16)), eps.to(torch.bfloat16),
        extent, cfg["scaffold"])
    got = densify_check({"in": src, "out": {k: low[k] for k in
                                            ("xyz", "scaling", "alive")}},
                        cfg, extent, torch.float32)
    return max(got["alive_flips"] / max(got["touched"], 1),
               *got["gaps"].values())
