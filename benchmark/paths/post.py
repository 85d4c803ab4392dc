"""The post-training cell: ``cli/train_post.main`` on the chunk's
hierarchy, resumed at a mid-run iteration and timed over its own loop.

Set-up writes the chunk's dataset as the training cell does, builds the
chunk's hierarchy from the seed on the device (its leaves: the chunk's
Gaussians and the scaffold's ring outside the chunk's box, whose leaves
and every node above them are anchors) and the pretrained exposures
beside it. The scene's hierarchy read (``scene.scene.read_hier``) is
replaced by one that hands over those arrays (the ``.hier`` file would
be ~0.6 GB), and ``train.checkpoint.load_flat`` by one that hands the
loop seeded Adam moments at the start iteration. The first
``checked_steps`` steps are recorded for the check; after
``warmup_steps`` the window opens, and it closes at the first step that
ends ``seconds`` later.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark.core import files
from benchmark.core.observe import Patches, StopWindow, ranged_factory
from benchmark.gen import hierarchy as ghier
from benchmark.gen import scene as gen
from benchmark.paths import train as ptrain
from benchmark.reference import post as rpost

LEAVES = ptrain.LEAVES
sync = ptrain.sync


def hierarchy_of(cfg: dict, inp: dict) -> dict:
    """The chunk's hierarchy over its Gaussians and the scaffold's ring
    (the sky stays out, as the hierarchy creator leaves it out)."""
    surf, n_sky = inp["surf"], cfg["skybox"]
    ring = slice(n_sky, cfg["scaffold"])
    n_ring = cfg["scaffold"] - n_sky
    dev = surf["xyz"].device
    sh = torch.zeros((n_ring, 16, 3), device=dev)
    sh[:, 0] = (inp["sc_rgb"][ring] - 0.5) / gen.SH_C0
    sh[:, 1:4] = inp["sc_rest"][ring]
    rot = torch.zeros((n_ring, 4), device=dev)
    rot[:, 0] = 1.0
    leaves = {
        "xyz": torch.cat([surf["xyz"], inp["sc_xyz"][ring]]),
        "sh": torch.cat([surf["sh"], sh]),
        "scaling": torch.cat([surf["scaling"], torch.full(
            (n_ring, 3), float(np.log(0.02)), device=dev)]),
        "rotation": torch.cat([surf["rotation"], rot]),
        "opacity": torch.cat([surf["opacity"], torch.full(
            (n_ring,), float(1.0 / (1.0 + np.exp(-1.0))), device=dev)]),
    }
    half = cfg["chunk_half"]
    locked = ((leaves["xyz"][:, 0].abs() > half)
              | (leaves["xyz"][:, 1].abs() > half))
    return ghier.build_hierarchy(leaves, ghier.morton_order(leaves["xyz"]),
                                 locked)


def exposures(cfg: dict, inp: dict, seed: int, device) -> dict:
    """The per-chunk stage's exposures, applied by post-training: 3x4
    affine maps near the identity, one per view name."""
    g = gen.generator(seed + 7, device)
    e = torch.eye(3, 4, device=device) + 0.01 * torch.randn(
        (len(inp["cams"]), 3, 4), generator=g, device=device)
    return {c["name"]: e[i] for i, c in enumerate(inp["cams"])}


def post_rows(cfg: dict, inp: dict, hier: dict):
    """The post state's leaves over [hierarchy nodes | sky rows]: the
    node attributes as stored (opacity activated, |x| activation), the
    scaffold's sky rows after them (opacity through the sigmoid, degree-1
    SH padded)."""
    n_sky = cfg["skybox"]
    dev = hier["xyz"].device
    sky_sh = torch.zeros((n_sky, 16, 3), device=dev)
    sky_sh[:, 0] = (inp["sc_rgb"][:n_sky] - 0.5) / gen.SH_C0
    sky_sh[:, 1:4] = inp["sc_rest"][:n_sky]
    rot = torch.zeros((n_sky, 4), device=dev)
    rot[:, 0] = 1.0
    shs = torch.cat([hier["shs"], sky_sh])
    return {
        "xyz": torch.cat([hier["xyz"], inp["sc_xyz"][:n_sky]]),
        "f_dc": shs[:, :1].contiguous(), "f_rest": shs[:, 1:].contiguous(),
        "opacity": torch.cat([hier["alpha"], torch.full(
            (n_sky,), float(1.0 / (1.0 + np.exp(-1.0))), device=dev)])[:,
                                                                       None],
        "scaling": torch.cat([hier["scaling"], torch.full(
            (n_sky, 3), float(np.log(1.5)), device=dev)]),
        "rotation": torch.cat([hier["rotation"], rot])}


def locked_rows(cfg: dict, hier: dict):
    m = hier["nodes"].shape[0]
    locked = torch.zeros(m + cfg["skybox"], dtype=torch.bool,
                         device=hier["xyz"].device)
    locked[hier["anchors"].long()] = True
    locked[m:] = True
    return locked


def seeded_moments(cfg: dict, rows: dict, locked, seed: int, device):
    """Adam's moments at the start iteration: zero on locked rows (their
    gradient is always zero), seeded on the others."""
    g = gen.generator(seed + 11, device)
    mu, nu = {}, {}
    for k in LEAVES:
        s = cfg["adam_scale"][k]
        m = (~locked).reshape((-1,) + (1,) * (rows[k].dim() - 1))
        mu[k] = torch.where(m, s * torch.randn(
            rows[k].shape, generator=g, device=device), 0.0)
        nu[k] = torch.where(m, (s * s) * (0.5 + torch.rand(
            rows[k].shape, generator=g, device=device)), 0.0)
    return mu, nu


def stream_views(n_views: int, k: int, start_it: int) -> list:
    """The first ``k`` views of the loop's stream, whose order is seeded
    with the start iteration, one view a step."""
    idx = np.arange(n_views)
    np.random.default_rng(start_it).shuffle(idx)
    return [int(i) for i in idx[:k]]


def stream_limits(k: int, start_it: int, device) -> list:
    """The first ``k`` granularity limits of the loop: log-uniform in
    [0.005, 0.1], drawn from its generator seeded with the start
    iteration."""
    g = torch.Generator(device=device)
    g.manual_seed(start_it)
    lo, hi = float(np.log2(0.005)), float(np.log2(0.1))
    return [torch.exp2(torch.rand((), generator=g, device=device)
                       * (hi - lo) + lo) for _ in range(k)]


# ---------------------------------------------------------------- the run --
def run(ctx) -> dict:
    import h3dgs_tpu_torch.parallel.step as dp_mod
    from h3dgs_tpu_torch.cli import train_post as cli
    from h3dgs_tpu_torch.hierarchy.tree import Hierarchy
    from h3dgs_tpu_torch.ops.adam import AdamState
    from h3dgs_tpu_torch.scene import scene as scene_mod
    from h3dgs_tpu_torch.train import checkpoint as ckpt_mod
    from h3dgs_tpu_torch.train import loop as loop_mod
    from h3dgs_tpu_torch.train import post_step as post_mod

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    start_it = traffic["start_iteration"]
    inp = ptrain.make_inputs(cfg, ctx.seed, dev)
    root = os.path.join(ctx.tmp, "chunk")
    ptrain.write_dataset(root, cfg, inp)
    hier = hierarchy_of(cfg, inp)
    hier_dir = os.path.join(root, "hierarchy")
    files.write_json(os.path.join(hier_dir, "exposure.json"),
                     {k: v.cpu().numpy().tolist() for k, v in
                      exposures(cfg, inp, ctx.seed, dev).items()})
    host = Hierarchy(**{k: v.cpu().numpy() for k, v in hier.items()})
    locked = locked_rows(cfg, hier)
    rows = post_rows(cfg, inp, hier)
    hold = [seeded_moments(cfg, rows, locked, ctx.seed, dev)]
    del inp, rows
    rec = {"views": [], "loss": [], "cuts": []}
    checks, window = {}, {}
    checked, warm = traffic["checked_steps"], traffic["warmup_steps"]
    p0, mu0, nu0 = {}, {}, {}

    def load_flat(_path, template):
        mu, nu = hold.pop()
        if template.capacity != mu["xyz"].shape[0]:
            raise RuntimeError("post rows differ from the seeded layout")
        step = torch.tensor(start_it, dtype=torch.int32, device=dev)
        p0.update(template.trainable_dict())
        mu0.update(mu)
        nu0.update(nu)
        opt = AdamState(mu=mu, nu=nu, step=step)
        zero = torch.zeros((1, 3, 4), device=dev)
        exp_opt = AdamState(mu={"exposure": zero}, nu={"exposure": zero},
                            step=step.clone())
        return template, opt, zero, exp_opt, start_it

    def record_checked(k, out):
        rec["loss"].append(out.photo_loss.float())
        if k == 1:
            norms = {}
            for name in out.opt.mu:
                grad = (out.opt.mu[name] - 0.9 * mu0[name]) / 0.1
                norms[name] = float(grad.norm())
            checks["grad_norms"] = norms
            mu0.clear()
            nu0.clear()
        if k == checked:
            now = out.state.trainable_dict()
            checks["change_norms"] = {n: float((now[n] - p0[n]).norm())
                                      for n in p0}
            p0.clear()

    def step_cb(it, out):
        k = it - start_it
        if k <= checked:
            record_checked(k, out)
        if k == warm:
            sync(dev)
            ctx.window_started()
            window.update(t0=time.perf_counter(), it0=it)
        elif k > warm:
            rec["cuts"].append(out.cut_size)
            if time.perf_counter() - window["t0"] >= ctx.seconds:
                sync(dev)
                window.update(t1=time.perf_counter(), it1=it)
                raise StopWindow

    def next_hook(args, kwargs, out):
        if len(rec["views"]) < checked:
            rec["views"].append([int(h.image_idx) for h in out[0]])
        return out

    orig_post = loop_mod.train_post

    def train_post(cfg_, scene, **kw):
        kw["step_cb"] = step_cb
        return orig_post(cfg_, scene, **kw)

    argv = ["-s", root, "-m", os.path.join(ctx.tmp, "model"),
            "--hierarchy", os.path.join(hier_dir, "hierarchy.hier"),
            "--scaffold_file", os.path.join(root, "scaffold"),
            "--skybox_locked", "--iterations", str(cfg["post_iterations"]),
            "--start_checkpoint", "seeded-midrun-moments"]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    with Patches() as pt:
        pt.set(scene_mod, "read_hier", lambda _path: host)
        pt.set(ckpt_mod, "load_flat", load_flat)
        pt.set(loop_mod, "train_post", train_post)
        pt.ranged(loop_mod.BatchedPrefetcher, "__next__", "post.view_next",
                  next_hook)
        pt.ranged(post_mod, "select_cut_gaussians", "post.cut")
        pt.set(dp_mod, "make_dp_post_step", ranged_factory(
            dp_mod.make_dp_post_step, "post.step"))
        pt.set(dp_mod, "make_post_view_grads", ranged_factory(
            dp_mod.make_post_view_grads, "post.view_grads"))
        pt.set(dp_mod, "make_post_update", ranged_factory(
            dp_mod.make_post_update, "post.update"))
        try:
            cli.main(argv)
        except StopWindow:
            pass
        else:
            raise RuntimeError("post-training ended before the window "
                               "closed")
    ctx.window_closed()
    del host
    return dict(window_s=window["t1"] - window["t0"],
                steps=window["it1"] - window["it0"],
                losses=[float(x) for x in rec["loss"]], checks=checks,
                views=rec["views"],
                cut_sizes=[int(c) for c in rec["cuts"]])


# --------------------------------------------------------------- the check --
def reference_check(ctx, res: dict, dtype=torch.float32,
                    half=False) -> dict:
    """Follow the first checked steps with the plain reference from the
    same seeded inputs (views in the stream's order, limits from the
    loop's generator seeded with the start iteration)."""
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    start_it = traffic["start_iteration"]
    inp = ptrain.make_inputs(cfg, ctx.seed, dev)
    hier = hierarchy_of(cfg, inp)
    exps = exposures(cfg, inp, ctx.seed, dev)
    views = ptrain.reference_views(inp, dev, cfg["jpeg_quality"])
    extent = ptrain.scene_extent(inp["cams"])
    rows = post_rows(cfg, inp, hier)
    locked = locked_rows(cfg, hier)
    mu, nu = seeded_moments(cfg, rows, locked, ctx.seed, dev)
    del inp
    st = {k: v.to(dtype) for k, v in rows.items()}
    st["mu"] = {k: v.to(dtype) for k, v in mu.items()}
    st["nu"] = {k: v.to(dtype) for k, v in nu.items()}
    st["step"] = start_it
    p0 = {k: st[k] for k in LEAVES}
    names = [c["name"] for c in ptrain.view_cameras(cfg)]
    limits = stream_limits(traffic["checked_steps"], start_it, dev)
    bg = torch.zeros(3, device=dev, dtype=dtype)
    m = hier["nodes"].shape[0]
    losses, work = [], []
    grad_norms = None
    for k, idx in enumerate(res["views"]):
        record = {}
        st = rpost.post_step(st, views[idx[0]], limits[k],
                             exps[names[idx[0]]], start_it + k + 1, bg,
                             extent, locked, hier["nodes"], hier["boxes"], m,
                             record, half=half)
        losses.append(record["photo"])
        work.append({"k1_pairs": record["k1_pairs"],
                     "k2_pairs": record["k2_pairs"],
                     "k2_contrib": record["k2_contrib"],
                     "visible": record["visible"],
                     "entries": record["entries"], "cut": record["cut"],
                     "nodes": m, "unlocked": int((~locked).sum()),
                     "pixels": cfg["width"] * cfg["height"]})
        if k == 0:
            grad_norms = {n: float(g.float().norm())
                          for n, g in record["grads"].items()}
    change = {k: float((st[k] - p0[k]).float().norm()) for k in LEAVES}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "work": work}


def compared_numbers(res: dict, check: dict) -> dict:
    out = ptrain.compared_numbers(res, check)
    out.pop("densify_gap")
    return out


def attempted(res: dict) -> int:
    return res["steps"]


def failed(res: dict) -> int:
    return 0


def control(ctx) -> dict:
    """The compared numbers with the reference computed in bfloat16 put
    in the program's place, and with the reference that leaves out half
    of each view (a planted fault), against the float32 reference."""
    start_it = ctx.traffic["start_iteration"]
    views = [[i] for i in stream_views(ctx.config["views"],
                                       ctx.traffic["checked_steps"],
                                       start_it)]
    want = reference_check(ctx, {"views": views})
    out = {}
    for name, kw in (("control_bf16", {"dtype": torch.bfloat16}),
                     ("fault_half_view", {"half": True})):
        got = reference_check(ctx, {"views": views}, **kw)
        out[name] = compared_numbers(
            {"losses": got["losses"], "steps": 0,
             "checks": {"grad_norms": got["grad_norms"],
                        "change_norms": got["change_norms"]}}, want)
    return out
