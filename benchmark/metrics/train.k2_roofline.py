"""K2 (blend backward) against its roofline: the counted least time of
the checked steps' backward blends (``work/blend_bwd``, summed) over the
device time of K2's launches in those same steps (traced apart, before
the window, in a ``--trace 1`` run)."""

from _common import roofline

from benchmark.work import blend_bwd


def read(view):
    work = view["check"].get("work") or []
    t = view["res"].get("k2_checked_s")
    if view.get("trace") is None or not work or not t:
        return None
    ws = [blend_bwd.work(w["k2_pairs"], w["k2_contrib"], w["visible"],
                         w["entries"], w["pixels"]) for w in work]
    return roofline(view, sum(o for o, _ in ws), sum(b for _, b in ws), t)
