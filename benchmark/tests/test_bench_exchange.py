"""The exchange_ms reader on synthetic traces: the NCCL kernels' device time
summed and divided by the traced steps; None where the trace holds no NCCL
kernel (a one-card cell)."""
from __future__ import annotations

import pytest

import bench_tiny  # noqa: F401  (the repository on the path)
from benchmark import run
from benchmark.trace import Trace

NCCL_SUM = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
NCCL_MAX = "ncclDevKernel_AllReduce_Max_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"


def _trace(kernels):
    return Trace(device=kernels, kernels=kernels, host=[], window=(0.0, 1.0))


def test_reads_nccl_kernels_over_steps():
    read = run.reader("exchange_ms")
    kernels = [("void blend_train_fwd_kernel(...)", 0.0, 0.5)]
    for i in range(3):  # three steps, a SUM and a MAX each
        t = 0.1 * i
        kernels += [(NCCL_SUM, t, t + 20e-6), (NCCL_MAX, t + 30e-6, t + 35e-6)]
    got = read(dict(trace=_trace(kernels), traced_steps=3))
    assert got == pytest.approx(1e3 * 3 * 25e-6 / 3)


def test_none_without_nccl_kernels():
    read = run.reader("exchange_ms")
    kernels = [("void ssim_fwd_kernel(...)", 0.0, 1e-5)]
    assert read(dict(trace=_trace(kernels), traced_steps=100)) is None
    assert read(dict(trace=_trace([]), traced_steps=100)) is None


def test_only_the_four_card_cell_reports_it():
    assert "exchange_ms" in [m["name"] for m in run.resolve("abc_nef.dense.4card").per_layer]
    for cell in ("abc_nef.sparse", "abc_nef.dense", "replica.sparse"):
        assert "exchange_ms" not in [m["name"] for m in run.resolve(cell).per_layer]


def test_four_card_cell_runs_its_own_deployment():
    cell = run.resolve("abc_nef.dense.4card")
    cluster = cell.config["cluster"]
    assert cell.config["name"] == "abc_nef_800_dp4"
    assert cluster["cards"] == cell.workload["chips"] == 4
    assert cluster["views_per_step"] == cell.traffic["views_per_step"]
    # the four-card deployment trains the one-card recipe unchanged
    one = run.resolve("abc_nef.dense").config
    for key in ("model", "preset", "optimization", "scene", "reduced"):
        assert cell.config[key] == one[key]
