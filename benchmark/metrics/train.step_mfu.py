"""The whole flat step against the card's float32 peak: the operations
a step's inputs need (``work/train_step``: live rows only), averaged over
the checked steps, over (window / steps x 67 TFLOP/s)."""

from _common import mean

from benchmark.work import peaks, train_step


def read(view):
    res, work = view["res"], view["check"].get("work") or []
    if view.get("trace") is None or not work or not res.get("steps"):
        return None
    ops = mean(train_step.ops(w["live"], w["pixels"], w["k1_pairs"],
                              w["k2_pairs"], w["k2_contrib"]) for w in work)
    t = res["window_s"] / res["steps"]
    return {"value": 100.0 * ops / (t * peaks.FLOPS_F32),
            "power_limit_w": view.get("power_limit_w")}
