"""Nothing that ``benchmark/run.py`` runs loads JAX or the JAX package,
top-level names compared whole."""
from __future__ import annotations

import sys

import pytest

from _tiny import run_in_child


def test_forbidden_names_compared_whole(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "h3dgs_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert all(not m.startswith(("h3dgs_tpu_torch", "jaxtyping"))
               for m in run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "h3dgs_tpu.ops", object())
    assert "h3dgs_tpu.ops" in run.forbidden_modules()


@pytest.mark.parametrize("workload", ["train_chunk", "serve_walk"])
def test_run_loads_no_jax(workload):
    probe = ("import atexit\n"
             "atexit.register(lambda: print('LOADED', sorted({m.split('.')[0]"
             " for m in sys.modules}), file=sys.stderr))")
    rc, out, err = run_in_child(workload, extra=probe)
    assert rc == 0, err[-3000:]
    loaded = err.rsplit("LOADED", 1)[1]
    for name in ("'jax'", "'jaxlib'", "'flax'", "'h3dgs_tpu'"):
        assert name not in loaded
    assert "'h3dgs_tpu_torch'" in loaded


def test_guard_refuses_a_run_that_loads_jax():
    rc, out, err = run_in_child(
        "serve_walk", extra="import types; sys.modules['h3dgs_tpu'] = "
                            "types.ModuleType('h3dgs_tpu')")
    assert rc == 3
    assert "h3dgs_tpu" in err
    assert out.strip().splitlines()[-1:] != [] and not out.strip(
    ).splitlines()[-1].startswith("{")
