"""The control on the card: the reference computed in TF32, put in the
program's place, departs from the float32 reference by several times what
the program does, on three seeds, at a size a test run holds (the abc_nef
cells' configuration at 256 x 256).  Needs a card:

    python3 -m pytest -m cuda benchmark/tests/test_bench_control.py
"""
from __future__ import annotations

import pytest
import torch

import bench_tiny  # noqa: F401  (the repository on the path)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["abc_nef.sparse", "abc_nef.dense"])
def test_control_departs(card, cell):
    from benchmark import calibrate, run

    c = run.resolve(cell)
    c.config["scene"].update(height=256, width=256)
    for seed in (101, 102, 103):
        r = calibrate.readings(c, seed, card)
        prog, ctl = r["program"], r["control"]
        assert max(ctl[n] / max(prog[n], 1e-12) for n in ctl) >= 3.0, r
