"""K1 (blend forward: pack pre-pass and blend kernel) against its
roofline: the counted least time of the checked frames' blends
(``work/blend_fwd``, summed) over the device time of K1's launches
inside those frames' renders (the ``bench.serve.checked`` ranges of the
window's trace)."""

from _common import roofline

from benchmark.work import blend_fwd


def read(view):
    tr = view.get("trace")
    work = view["check"].get("work") or []
    if tr is None or not work:
        return None
    if tr.range_count("bench.serve.checked") != len(work):
        return None
    t = tr.kernel_in_range_s("bench.serve.checked", "blend_fwd_kernel",
                             "pack_kernel")
    ws = [blend_fwd.work(w["k1_pairs"], w["visible"], w["entries"],
                         w["pixels"]) for w in work]
    return roofline(view, sum(o for o, _ in ws), sum(b for _, b in ws), t)
