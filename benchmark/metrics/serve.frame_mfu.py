"""The whole frame against the card's float32 peak: the operations a
frame's inputs need (``work/frame``; selection and interpolation only
for frames that selected a cut), averaged over the checked frames, over
(window / frames x 67 TFLOP/s)."""

from _common import mean

from benchmark.work import frame, peaks


def read(view):
    res, work = view["res"], view["check"].get("work") or []
    if view.get("trace") is None or not work or not res.get("rendered"):
        return None
    fresh = 1.0 - res["reused"] / res["rendered"]
    per = []
    for w in work:
        full = frame.ops(w["nodes"], w["cut"], w["k1_pairs"])
        select = (w["nodes"] * (frame.NODE_SIZE_OPS + frame.NODE_TEST_OPS
                                * frame.LADDER_TESTS)
                  + w["cut"] * frame.LERP_OPS)
        per.append(full - (1.0 - fresh) * select)
    t = res["window_s"] / len(res["latency_s"])
    return {"value": 100.0 * mean(per) / (t * peaks.FLOPS_F32),
            "power_limit_w": view.get("power_limit_w")}
