"""The control, the plain reference computed in the next lower precision
(bfloat16) put in the program's place, comes out not correct; for
training so does the planted fault that leaves out half of each view.
The CPU cases run at the tests' tiny sizes; the card case, at a size a
test run holds, skips without a card (decided inside the test)."""
from __future__ import annotations

import json
import os

import pytest
import torch

from _tiny import CONFIG, ROOT, SEED, TRAFFIC

from benchmark import control


def _limits(workload):
    with open(os.path.join(ROOT, "benchmark", "limits",
                           workload + ".json")) as f:
        return {k: v["limit"] for k, v in json.load(f)["numbers"].items()}


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v is not None and v > limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("workload", ["train_chunk", "serve_walk",
                                      "post_chunk", "serve_look"])
def test_control_is_not_correct(workload):
    got = control.read(workload, SEED, torch.device("cpu"),
                       CONFIG[workload], TRAFFIC[workload])
    limits = _limits(workload)
    for name, numbers in got.items():
        assert _fails(numbers, limits), (name, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train_chunk", "serve_walk",
                                      "post_chunk"])
def test_control_is_not_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    size = dict(CONFIG[workload])
    size.update(width=640, height=360)
    got = control.read(workload, SEED, torch.device("cuda", 0), size,
                       TRAFFIC[workload])
    limits = _limits(workload)
    for name, numbers in got.items():
        assert _fails(numbers, limits), (name, numbers)
