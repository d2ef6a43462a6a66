#!/usr/bin/env python3
"""Drive the PyTorch port of CurveGaussian on one CUDA card, or on N.

    python3 chip_smoke.py            # build, check, train; needs one GPU
    python3 chip_smoke.py --profile  # also print torch.profiler tables of the bench step
                                     # (eager and graphed) and of a step of the dataset scene
    python3 chip_smoke.py --cards N  # phase 13 alone, N = 2 or 4 ranks over NCCL, one card
                                     # each; fails with fewer than N cards

(``--cards N --rank R`` runs one rank of phase 13; the phase starts them
itself.)  Phases 1-11 below are the default run, on one card; phase 13
is ``--cards N``.

1. Prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions.
2. Builds every kernel under ``curve_gaussian_tpu_torch/csrc/`` (one nvcc
   per source, all at once) into ``build/torch_kernels/``.
3. Holds each kernel of the training path against its plain PyTorch
   version on the card, at the shapes the main path gives it, and times
   both (CUDA events, median), beside the least time the card could take
   (``bound_ms``; a blend kernel's operations are counted over the
   (instance, pixel) pairs of this run's data that pass the alpha gate and
   those that contribute) and, for SSIM, a cuDNN conv2d SSIM
   (``library_ms``, never called by the port).  K1 is also held against
   K3 at (F, F, T), the same function, cull and code in another kernel
   (bitwise), and K2 against K6b, the same accumulator through raw
   tile-local sums and their recombination, each pair timed in turns; the
   tile lists and what the cull skips are printed.  K2 and the slot ->
   Gaussian reduction (``reduce_slots``, timed beside ``index_add_``) run
   three times each on the same inputs and must be bitwise equal (every
   sum of the backward runs in a fixed order); K2 must equal its slot rows
   through the reduction.  K1, the reduction and K8
   must equal their plain versions.  The projection's two kernels
   (``project_fwd``, ``project_bwd``) on the main path's Gaussians and
   view 0: every forward output equal to ``preprocess_plain``'s, the four
   gradients within 1e-5 of the largest of autograd's through it, three
   launches of each bitwise equal, each timed in one CUDA graph of 50
   launches beside its bound by bytes and the plain version in a graph.
   The binning's kernels (``bin_tiles``) on the same Gaussians and view,
   binned as the step bins them: every field of ``Binning`` equal to
   ``bin_gaussians_plain``'s, the slots table included, three launches
   bitwise equal, timed in one CUDA graph of 50 launches beside its bound
   by bytes and the plain version in a graph.  K7 and K8's launch shapes
   (blocks, blocks per SM, waves) are printed, and one K7 call must enqueue one
   device kernel, launched by its wrapper (counted from a CUDA graph
   capture of the call).
4. Checks one whole training step on the card against the same step on
   the CPU (plain versions) on a small scene.
5. Runs the main path at the bench configuration of the JAX package:
   3,375 grid seed curves in a capacity of 4,096 x 12 Gaussians, 4 ring
   views at 512x512, default configs: 5 warm-up steps, 20 timed steps, then
   2 steps with the mask and connectivity terms on, all eager
   (``train_step``).  Every kernel's launch counter must rise during that
   run, and the loss and gradients must stay finite.  Then, from the state
   after those steps, the step as the driver runs it, captured as a CUDA
   graph and replayed (``train_steps_scan``):
   a. one graphed step and one eager step from the same state: the loss,
      each group's gradient (from Adam's first moment) and the post-Adam
      parameters, moments and statistics bitwise equal;
   b. 25 graphed steps against 25 eager ones: every loss and the final
      state bitwise equal;
   c. 20 eager and 20 graphed steps in turns (eager, graphed, graphed,
      eager) on the host clock: ms/step, steps/s, Mpix/s (steps/s x 512^2),
      the capture's seconds and each turn's peak memory;
   d. with ``--profile``, the graphed step's device busy share.
5b. (before 5's graphed step) One eager step of the default flavor, one
   with the mask and connectivity terms, one of each of the table,
   indirect and basis flavors, and the full-channel render's gradient,
   under ``torch.use_deterministic_algorithms(True, warn_only=True)`` (set
   here only, then unset), with every op they dispatch on the card logged:
   each op whose CUDA kernel adds in no fixed order (``NONDET_OPS``: the
   flag swaps most of them without a warning) and each warning of the flag
   is printed with the reason it is order-free on these paths
   (``ORDER_FREE``); any other fails.
6. The captured step's device work: its graph's nodes by type (read with
   the driver's ``cuGraphGetNodes``), beside one eager step captured the
   same way; no host node and no copy from host memory, and the wrappers
   must have launched the projection's two kernels, the binning's,
   K1, K2, the reduction, K7 and K8 once each during the capture.
6b. The view-batched step (``parallel/sharding.py``), B = 2 and B = 4
   views per optimizer step over the bench views, from the same state: one
   step captured whole as a CUDA graph (``parallel_train_steps_scan``), its
   capture holding K1, K2, the reduction, K7 and K8 B times each and no
   host work; that step against the same step run eagerly
   (``parallel_train_step``): bitwise equal; and against Adam applied by
   hand to the mean of B ``step_grads`` calls (its own order of operations
   around the same sums): the loss within 1e-6 relative, every state array
   within 1e-6 of its max; then 20 B-view steps
   in turns with the same views as one-view graphed steps (one-view, B,
   B, one-view): ms per step and per view on the host clock, each turn's
   peak memory, and the device time of one replay of each graph (CUDA
   events).
7. The full-channel render, from the state after the eager steps:
   a. K3, K4 and K5 against their plain versions at the shapes the paths
      below give them: (geo, invd, ones) = (T, T, T) (the eval render),
      (F, F, T) (the table and indirect flavors, K5 included) and, on a
      small scene, (T, T, F) (a per-splat colour), with what their cull
      skips; K4 and K5 three times each on the same inputs, bitwise equal;
      K5 also against K2 on the indirect flavor's inputs (its rows through
      the reduction are K2's accumulator: bitwise), timed in turns;
   b. ``eval_render`` of each of the 4 views (no gradient): finite maps,
      the render in [0, 1], K3 once per view; then (the graphed eval
      render) ``eval_renders`` of the 4 views, one captured CUDA graph
      replayed once per view: the capture holding K3 once and no host work
      (its ``graph_nodes``), K3 run once per view and once in the warm-up on
      the device, render, invdepth, alpha and final_T bitwise equal to
      ``eval_render``'s and dir within 1e-6 of its max; eager and graphed in
      turns (eager, graphed, graphed, eager): host ms a view, each turn's
      peak memory, one replay's device ms (``replay_ms``) and the capture's
      seconds;
   c. the gradient of sum(render k1 + invdepth k2 + alpha k3 + dir k4) to
      xyz, scale, quat and opacity: finite and nonzero;
   d. ``make_scene`` at ``train.py --synthetic``'s defaults (seed 0, 8
      curves, 3 lines, 24 views at 256x256): edge maps finite, in [0, 1]
      and not empty;
   e. ``step_grads`` under ``CGT_BLEND_FLAVOR=table`` (K3 + K4) and
      ``=indirect`` (K3 + K5) against the default flavor (K1 + K2), then a
      few timed ``train_step``s of each flavor.
   Each path's launch counters are set to 0 just before it and read just
   after; each kernel of the path must have launched.
8. The basis flavor of the training backward (K6b: K2's culled pass into
   raw tile-local sums per slot, then one recombination per (instance,
   tile)), on the main path's K2 inputs: against its plain version and
   against K2 (the same function through another formulation), timed
   beside its bound, with what its cull skips, three times on the same
   inputs (bitwise equal); ``step_grads`` under
   ``CGT_BLEND_FLAVOR=basis`` against the default flavor; then 5
   ``train_step``s that must launch K6b 5 times and K2 never.
9. The training driver at full width: ``curve_gaussian_tpu_torch.train``'s
   ``main`` on the synthetic scene (24 views of 512x512, the 15^3 seed
   grid in capacity 4,096, 12 Gaussians per curve, 600 iterations with the
   schedule compressed to fit: densify, the densify_until prune, prune and
   trim, split, merge), test renders at 300 and 600, a checkpoint at 550.
   Its chunks replay captured step graphs.  It prints iterations per
   second, host seconds by phase (the captures' among them), every
   surgery event with its curve count, capacity and host time, the tile
   and big capacity changes, peak memory, each capture, and the launches
   of every kernel counted through the replays (``check_step_launches``:
   the wrappers count a captured launch once, so the device's launches
   are their counts less the captures' plus each capture's times its
   replays; each capture must hold the projection's two kernels, the
   binning's, K1, K2, the reduction, K7 and K8 once, the replays must
   be the iterations, so each of them runs once per step and per eager
   warm-up step; the test renders replay their render graphs, each
   capture holding the projection's forward, the binning's kernels and
   K3 once, so K3 runs once per view of make_scene, per test view
   rendered and per warm-up render, and the projection's forward and the
   binning's kernels once more per K3 launch), and eval.json's
   Chamfer, precision, recall and F-score; runs it a second time from the
   same seed, which must end in bitwise-equal state arrays and write
   byte-equal ``parametric_edges.json`` and ``eval.json``; checks that the
   artifacts exist, that the checkpoint loads into a template leaf by leaf
   bitwise,
   and that a second run resumes from it to 600 (the same launch checks
   over its 50 steps and its test render at 600) and writes its own ``parametric_edges.json``.
9b. The driver run of 9 (without the resume) at ``--views-per-step 4``:
   each chunk through ``parallel_train_steps_scan``, each capture holding
   K1, K2, K7 and K8 4 times and each kernel run 4 times per step and
   warm-up step on the device; its it/s, views/s, final curve count and
   host seconds by phase beside the one-view run's, finite losses and
   ``eval.json``.
10. A dataset scene at the reference's operating point:
   a. the port's scene maker at its defaults (50 views of 1600x1600, 24
      Beziers and 8 lines, tile capacity 1024): K1 once per view, no view
      overflowing;
   b. ``load_scene`` at ``-r 2`` (800x800): ``read_png`` of view 0 must
      equal the array written, and so must its re-encoding with Paeth on
      every row; the load and one view's read (both unfilter paths) and
      resize are timed on the host;
   c. the projection's two kernels (as in 3), K1 (bitwise), K2, K7 and K8
      (bitwise) against their plain versions on one training step of the
      loaded scene, K3 (bitwise) on its eval
      render's inputs, K7/K8's launch shapes and one K7 call's device work,
      all at 800x800, and K1 (bitwise) on view 0 of the scene maker at
      1600x1600;
   d. ``train.main -s <scene> -r 2 --eval`` for 600 iterations with test
      renders at 300 and 600, through the step graphs: K1, K2, K7 and K8
      once per step and warm-up step (counted as in 9), K3 once per test
      view (replayed) and warm-up render, finite losses and ``eval.json``;
   e. the graphed eval render of 7b on the trained state over the 50 test
      views at 800x800.
11. Evaluation and export:
   a. ``render_curves`` of the driver's ``parametric_edges.json`` at its
      defaults (a 60-frame orbit at 512x512), its frames one captured render
      replayed: K3 once per frame and once in the warm-up, each PNG read
      back as the array written, K3 (bitwise) on frame 0's inputs, which
      must render frame 0, frames 0 and 59 the SHA-256 of an eager render
      of their cameras; host ms per frame;
   b. the batched ``ssim`` (the band-matrix path) of the 4 bench views'
      renders against their ground truths: within 1e-5 of K7's per-pair
      mean, with a finite gradient;
   c. an ABC-format GT of the dataset scene's ``gt_edges.json`` and
      ``run_batch_abc --in-process`` over two scans, the dataset run's
      finished output (skipped) and the dataset scene trained 300
      iterations through the step graphs: no failure, finite
      ``eval_summary.json`` (per-type keys too); a second run skips both;
   d. ``evaluate_replica`` of the dataset run's curves over 5 views: the
      counts of stats.json, frames of [H, 2W, 3].
13. ``--cards N`` alone: every card's name and power limit, ``nvidia-smi
   topo -m`` and the NCCL version, then N ranks (this script with
   ``--cards N --rank R``, ``multihost.run_ranks``), rank r on cuda:r, over
   NCCL, at the bench configuration (a fresh state, 4 views a step, 4/N a
   rank):
   a. the fused step (one captured graph, its SUM and MAX collectives
      inside): one step, then 20 steps twice on the host clock, each
      turn's device time (CUDA events) and peak memory, the two turns'
      losses within 1e-4 relative; the exchange alone; the bytes a step
      exchanges;
   b. on rank 0, the fused step against the one-process 4-view step (graphed
      and eager) within 1e-6, with the same slack;
   c. the fused graph's nodes by type: NCCL kernels, no host node;
   d. each rank's K1, K2, K7 and K8 launches on the device: 4/N per step
      and warm-up step;
   e. the driver run of 9 at ``--views-per-step 4 --n-devices N --device
      cuda:r`` (600 iterations): every capture with NCCL kernels, the launches counted through the replays, the
      fused step's device time, it/s, seconds by phase; rank 0 alone
      writes;
   f. ``render_curves --n-devices N`` of the driver's curves (each rank's
      band and the sum one captured graph with NCCL kernels, K3 once per
      frame and warm-up) bitwise equal to one process on every frame;
   g. ``dryrun_multichip(N)`` over NCCL;
   h. (after a.) the fused form's 20 steps with device spans
      (``engine/spans.py``): the seven spans on every rank, ``exchange``
      from the stamp before the SUM to the one after the MAX, each rank's
      exchange ms printed beside the others'.
   The ranks' states must be bitwise equal after every chunk.  Each rank
   has ``CARDS_TIMEOUT_S``; one still running ``CARDS_STACKS_BEFORE_S``
   before it prints every thread's Python stack, and a phase that times out
   prints each rank's exit or time-out, its seconds and its output.  Then, on
   cuda:0, the projection's two kernels, K1, K2, K7, K8 (at the bench step) and K3 (at rank 0's band of
   ``render_curves``' frame 0) against their plain versions; the kernel
   line gives each rank's launches in e and f.

Any failed check exits non-zero.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
``count`` from ``torch.cuda.device_count()``.
"""
from __future__ import annotations

import json
import os
import re
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from curve_gaussian_tpu_torch import _build
from curve_gaussian_tpu_torch.config import OptimizationConfig, PipelineConfig
from curve_gaussian_tpu_torch.data import png as PNG
from curve_gaussian_tpu_torch.data import synthetic
from curve_gaussian_tpu_torch.engine import optim, spans
from curve_gaussian_tpu_torch.engine import train as T
from curve_gaussian_tpu_torch.engine.graph_nodes import graph_nodes
from curve_gaussian_tpu_torch.models import curve_state as cs
from curve_gaussian_tpu_torch.models import losses as L
from curve_gaussian_tpu_torch.ops import binning as BN
from curve_gaussian_tpu_torch.ops import binning_cuda as BC
from curve_gaussian_tpu_torch.ops import projection as PP
from curve_gaussian_tpu_torch.ops import rasterize_cuda as RC
from curve_gaussian_tpu_torch.ops import ssim_cuda as SC
from curve_gaussian_tpu_torch.ops import tile_blend_cuda as TB
from curve_gaussian_tpu_torch.ops.binning import bin_gaussians, tile_grid
from curve_gaussian_tpu_torch.ops.render import render
from curve_gaussian_tpu_torch.parallel import multihost as MH
from curve_gaussian_tpu_torch.parallel import sharding as PS
from curve_gaussian_tpu_torch.scripts.cell_turns import (cuda_ms, splat_inputs, step_inputs,
                                                        tile_inputs)

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, float32 outside
# the tensor cores (an FMA counts 2), and the special-function unit's exp2,
# 16 results per clock and SM against the float32 lanes' 128 FMAs (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability 9.0)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_EX2_PER_S = PEAK_F32_FLOP_PER_S / 16

# Float operations of the blend kernels, counted from their source (a
# negation is a free operand modifier), charged to the (instance, pixel)
# pairs of this run's data that need them: the gate to every candidate (a
# live pair inside the instance's alpha >= 1/255 support, where it passes;
# a pair outside needs no evaluation, as K1/K2 show by skipping it); the
# rest only to a contributing pair (a candidate that passes the T test).
EXPF_OPS = 10  # expf's SASS on sm_90a: 4 FFMA (2 each), FADD, FMUL; and a MUFU.EX2
GATE_OPS = 2 + 9 + EXPF_OPS + 2 + 2  # offsets, power, expf, alpha (mul, min), two gates
T_OPS = 3  # alpha T, T - alpha T, the T test
MOMENT_OPS = T_OPS + 2 + 2 + 4 + 12  # prefix, 1/(1-a), g_alpha, 6 products and 6 sums
# K6b's recombination per contributing instance: the local centre 2, M1 2,
# M2 2, M3 5, M4 7, M5 5 (its raw sums cost what K2's moments cost per pair)
RECOMB_OPS = 23
# per pixel of the SSIM kernels
K7_OPS = 239  # products 3, two 11-tap passes over 5 maps 220, SSIM map 16
K8_OPS = 437  # moments 223, d-maps 30, adjoint blur of 4 maps 176, combine 8


def k3_ops(na: int) -> int:
    """K3's float operations per contributing pair: T_OPS and a product and
    a sum for each of the na accumulated channels (K1: na = 0)."""
    return T_OPS + 2 * na


def k4_ops(nch: int, ngch: int) -> int:
    """K4's float operations per contributing pair, nch channels, ngch of
    them with a field: T_OPS, 1/(1-a) 2, g_alpha's start 2, per channel the
    prefix 2 and g_alpha 6 (2 fewer for the ones colour, a product by 1), d
    power 2, the five conic and mean gradients with their sums 21, the
    opacity's 2 and each channel field's 2."""
    return T_OPS + 2 + 2 + 8 * nch - 2 * (nch - ngch) + 2 + 21 + 2 + 2 * ngch


def pair_counts(fields, gidx, counts, H: int, W: int):
    """Counts of one blend's inputs, from the plain front-to-back pass:
    (instance, pixel) pairs that are live (the pixel is in the image and has
    not stopped, the slot is listed), candidates (live and through the gate
    power <= 0, alpha >= 1/255) and contributing (candidates that pass the T
    test); the instances with a contributing pair; and, for K1-K4's cull:
    the live pairs inside the box of a warp that evaluates them (its 8x4
    pixel rectangle meets the instance's ``support_box``) and the (warp,
    instance) visits."""
    ww, wh = 8, 4  # K1-K4's warp rectangle (csrc/tile_blend.cu: CULL_WW x CULL_WH)
    with torch.no_grad():
        nty, ntx = tile_grid(H, W)
        dev = fields.device
        px, py = RC._pixels(nty, ntx, fields.dtype, dev)
        pay = fields[gidx.long()]
        box = RC.support_box(fields)[gidx.long()]  # [T, K, 4]
        p = torch.arange(RC.TILE_PIX, device=dev)
        lx, ly = p % RC.TILE_W, p // RC.TILE_W
        wid = (ly // wh) * (RC.TILE_W // ww) + lx // ww  # warp rectangle of each pixel
        nw = int(wid.max()) + 1
        w = torch.arange(nw, device=dev)
        ox = ((torch.arange(nty * ntx, device=dev) % ntx) * RC.TILE_W)[:, None]
        oy = ((torch.arange(nty * ntx, device=dev) // ntx) * RC.TILE_H)[:, None]
        rx0 = (ox + (w % (RC.TILE_W // ww)) * ww).float()
        ry0 = (oy + (w // (RC.TILE_W // ww)) * wh).float()
        act = (px < W) & (py < H)
        T = torch.ones_like(px)
        z = torch.zeros((), dtype=torch.int64, device=dev)
        n = dict(live=z, cand=z, contrib=z, inst=z, evaluated=z, visits=z)
        for j in range(int(counts.max())):
            listed = (j < counts)[:, None]
            live = act & listed
            b = box[:, j]
            meets = ((b[:, 0:1] <= rx0 + (ww - 1)) & (b[:, 1:2] >= rx0)
                     & (b[:, 2:3] <= ry0 + (wh - 1)) & (b[:, 3:4] >= ry0))  # [T, nw]
            n["live"] = n["live"] + live.sum()
            n["evaluated"] = n["evaluated"] + (meets[:, wid] & live).sum()
            warp_live = torch.zeros(meets.shape, dtype=torch.int32, device=dev).index_add_(
                1, wid, live.int())
            n["visits"] = n["visits"] + (meets & (warp_live > 0)).sum()
            was = act
            _, ag, _, _, contrib, T, act = RC._composite_step(pay[:, j], px, py, T, act)
            n["cand"] = n["cand"] + (was & listed & (ag > 0)).sum()
            c = contrib & listed
            n["contrib"] = n["contrib"] + c.sum()
            n["inst"] = n["inst"] + c.any(dim=1).sum()
    return {k: int(v) for k, v in n.items()}


def blend_bound(nbytes: float, pairs, contrib_ops: int, inst_ops: int = 0):
    """bound_ms of a blend kernel: GATE_OPS and one exp2 for each candidate
    pair (a pair outside the instance's alpha >= 1/255 support needs no
    evaluation: K1/K2 skip it), contrib_ops for each contributing pair,
    inst_ops for each contributing instance."""
    ops = pairs["cand"] * GATE_OPS + pairs["contrib"] * contrib_ops + pairs["inst"] * inst_ops
    return bound_ms(nbytes, ops, pairs["cand"])


def pairs_note(pairs) -> str:
    live = max(pairs["live"], 1)
    return (f"pairs live {pairs['live']} candidate {pairs['cand']} "
            f"({100 * pairs['cand'] / live:.2f}%) contributing {pairs['contrib']} "
            f"({100 * pairs['contrib'] / live:.2f}%), contributing instances {pairs['inst']}")


def cull_note(pairs, counts, who: str) -> str:
    """The tile lists and what the cull of `who` (every blend kernel shares
    it) makes of them."""
    c = counts.double()
    note = (f"{who}: tile lists mean {float(c.mean()):.1f} p90 "
            f"{float(torch.quantile(c, 0.9)):.0f} peak {int(c.max())}; cull (8x4 warp "
            f"rectangles, counted on the float32 mirror of the box, not in the kernels): live "
            f"pairs inside the boxes of the warps that evaluate them {pairs['evaluated']} "
            f"({100 * pairs['evaluated'] / max(pairs['live'], 1):.2f}% of live), (warp, "
            f"instance) visits {pairs['visits']}")
    return note


# tolerances of kernel against plain version (max error over max |plain|)
TOL = {
    # same float32 operations in the same order (-fmad=false, expf): only a
    # gate flip at a threshold could move a pixel
    "blend_train_fwd": 1e-5,
    # float32 sums in another order (warp tree, warps, quarters, slots vs
    # torch.sum + index_add_) over up to ~1e5 terms per Gaussian
    "blend_train_bwd": 1e-4,
    # the same float32 adds in the same order as the plain version
    "reduce_slots": 0.0,
    "ssim_fwd": 1e-5,  # absolute, on the value, as tests/test_ssim.py
    "ssim_bwd": 1e-4,  # tap sums in one order, the partial sums in another
    # as K1: the same operations in the same order
    "tile_blend_fwd": 1e-5,
    # per-slot rows: each a float32 sum over a tile's 1,024 pixels, in warp
    # tree, warp and quarter order against torch.sum's
    "tile_blend_bwd": 1e-4,
    "blend_moment_bwd": 1e-4,
    # the same D' as K2, its six sums over a tile's pixels in warp tree,
    # warp and quarter order against torch.sum's, then the same recombination
    "blend_train_bwd_basis": 1e-4,
    # the plain version's float32 operations in its order, its GEMM's and
    # GEMV's fused multiply-adds included: every output equal
    "project_fwd": 0.0,
    # the four gradients' sums in another order than autograd's
    "project_bwd": 1e-5,
    # integer tables from the plain version's cull, keys and order: every
    # field of Binning equal
    "bin_tiles": 0.0,
}
# K6b against K2 (max error over max |d fields| of K2): the same moments
# through the raw local sums and their recombination, which cancels terms
# up to ~31^2 times the result's size in float32
BASIS_TOL = 1e-3
# the table and indirect flavors' gradients against the default flavor's,
# per parameter group (max error over max |default|).  The forwards (K1;
# K3 at (F, F, T)) agree bitwise, so only the backward differs: K4 forms
# each pixel's field gradients and sums them per slot, K2 sums moments and
# maps them to fields per Gaussian, in float32 sums of
# ~1e5 terms of both signs in other orders.  K2 against its own plain
# version reads ~1e-7 here; 1e-3 leaves room for that cancellation.
FLAVOR_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_lines() -> list:
    """Every card's ``nvidia-smi`` name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()


def smi_line() -> str:
    return smi_lines()[0]


def bound_ms(nbytes: float, nops: float, nexp: float = 0):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = max(nops / PEAK_F32_FLOP_PER_S, nexp / PEAK_EX2_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rel_err(a, b) -> float:
    d = (a.double() - b.double()).abs().max().item()
    m = b.double().abs().max().item()
    return d / m if m > 0 else d


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    profile = "--profile" in sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    nvcc_v = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc_v.stdout.strip().splitlines()[-1]}", flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- build -------------------------------------------------------------
    t0 = time.time()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"([a-z_]+_kernel)(I((?:Lb[01]E)+)E)?", line)
                fn = (m.group(1) + "<" + ",".join(re.findall(r"Lb([01])E", m.group(3) or ""))
                      + ">") if m else line.strip()
            elif "registers" in line or "bytes stack frame" in line:
                print(f"  ptxas {name} {fn}: {line.strip()}")

    # -- bench configuration ---------------------------------------------------
    H = W = 512
    n_views, M = 4, 12
    cams = synthetic.ring_cameras(n_views, H, W, device=dev)
    rng = np.random.default_rng(0)
    gts = [torch.tensor(rng.uniform(size=(H, W)) ** 4, dtype=torch.float32, device=dev)
           for _ in range(n_views)]
    state = cs.init_state(synthetic.grid_seed_points(15), n_views=n_views, n_gaussians=M,
                          device=dev)
    opt_cfg, pipe_cfg = OptimizationConfig(), PipelineConfig()
    print(f"main path: {int(state.alive.sum())} curves in capacity {state.capacity}, "
          f"{state.capacity * M} Gaussians, {H}x{W}, {n_views} views", flush=True)

    # -- kernels against their plain versions, at the main path's shapes ------
    inputs = step_inputs(state, cams[0], gts[0], pipe_cfg, slots=True)
    kernels, pairs, acc = train_kernels(state, cams[0], inputs, gts[0], "", library=True)
    fields, binning, col, finT, gc, gtt = inputs
    k2_inputs = (fields, binning.gather_idx, binning.counts, col, finT, gc, gtt, binning.slots)
    yardsticks(k2_inputs, torch.zeros(1, device=dev))
    ssim_checks(col, gts[0])

    # -- one whole step on the card against the same step on the CPU ----------
    small_check()

    # -- the main path -----------------------------------------------------------
    ts = T.init_train_state(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in WRAPPERS.values():
        w.launches = 0
    losses = []

    def step(i, use_mask=False, conn_on=None):
        nonlocal ts
        ts, m = T.train_step(ts, cams[i % n_views], gts[i % n_views], 0.0, opt_cfg, pipe_cfg,
                             use_mask=use_mask, n_gaussians=M, conn_on=conn_on)
        losses.append(m["total"])
        return m

    t0 = time.time()
    for i in range(5):
        step(i)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    t0 = time.time()
    for i in range(20):
        m = step(5 + i)
    torch.cuda.synchronize()
    dt = time.time() - t0
    tele = {k: int(m[k]) for k in ("overflow", "tile_peak", "big_peak", "big_overflow")}
    steps_per_s = 20 / dt
    t0 = time.time()
    for i in range(2):
        m2 = step(25 + i, use_mask=True, conn_on=True)
    torch.cuda.synchronize()
    masked_s = (time.time() - t0) / 2
    launches = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    loss_v = torch.stack(losses).cpu()
    print(f"main path: 27 steps; losses first {loss_v[0]:.6f} last {loss_v[-1]:.6f}; "
          f"masked-step terms {sorted(m2)}", flush=True)
    print(f"main path: {steps_per_s:.3f} steps/s ({1e3 / steps_per_s:.3f} ms/step), "
          f"{steps_per_s * H * W / 1e6:.3f} Mpix/s fwd+bwd, warm-up 5 steps {warm_s:.2f} s, "
          f"mask+connectivity step {masked_s * 1e3:.1f} ms, peak memory "
          f"{peak / 2**30:.3f} GiB, telemetry {tele}, launches {launches}", flush=True)
    if not bool(torch.isfinite(loss_v).all()):
        fail(f"non-finite loss in the main path: {loss_v.tolist()}")
    _, _, grads, goff, _, _, _ = T.step_grads(ts, cams[0], gts[0], 0.0, opt_cfg, pipe_cfg,
                                              use_mask=True, n_gaussians=M, conn_on=True)
    for name, t in list(grads.items()) + [("mean2d_offset", goff)] + list(ts.params.items()):
        if not bool(torch.isfinite(t).all()):
            fail(f"non-finite values in {name} after the main path")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the main path")
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # -- the step and render-gradient paths under deterministic algorithms ------
    deterministic_ops(ts, cams, gts, opt_cfg, pipe_cfg, M)

    # -- the main path through the step graph ----------------------------------
    graphed_step(ts, cams, gts, opt_cfg, pipe_cfg, M, profile)

    # -- the view-batched step (B = 2, 4) through its step graph ----------------
    view_batches(ts, cams, gts, opt_cfg, pipe_cfg, M, smi)

    # -- the full-channel render ---------------------------------------------
    kernels += full_channel(ts, cams, gts, opt_cfg, pipe_cfg, M, dev, smi)

    # -- the basis flavor (K6b), on the main path's K2 inputs -------------------
    kernels.append(basis_flavor(k2_inputs, acc, pairs, ts, cams, gts, opt_cfg, pipe_cfg, M))

    if profile:
        profile_step(lambda: [step(i) for i in range(2)], 2, "eager bench step")

    # -- the training driver at full width, one view and four views a step ---------
    views_driver(dev, driver(dev), smi)

    # -- a dataset scene at the reference's operating point ------------------------
    scene = dataset_scene(dev, smi, profile)

    # -- evaluation and export ------------------------------------------------------
    kernels.append(eval_export(dev, ts, cams, gts, pipe_cfg, scene))

    print(json.dumps({"kernels": [{k: v for k, v in d.items() if k != "rel_err"}
                                  for d in kernels]}), flush=True)
    print(smi, flush=True)
    count = torch.cuda.device_count()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


BLEND_SRC = "curve_gaussian_tpu_torch/csrc/tile_blend.cu"
PROJECTION_SRC = "curve_gaussian_tpu_torch/csrc/projection.cu"
# the projection's bytes a Gaussian: the forward reads the mean, scale,
# quaternion, opacity and alive flag (45 B) and writes mean2d, conic,
# depth, opacity, radius, extent and valid (41 B); the backward reads the
# four inputs (44 B) and the four cotangents (28 B) and writes the four
# gradients (44 B)
PROJECT_FWD_BYTES = 86
PROJECT_BWD_BYTES = 116
BINNING_SRC = "curve_gaussian_tpu_torch/csrc/binning.cu"
# the binning's bytes: a Gaussian's mean2d, conic, depth, opacity, extent
# and valid flag read (37 B); a candidate pair's key written and read once
# (16 B); a table entry's index and flag (5 B), a tile's count (4 B) and
# each slot row of the slots table (4 B) written
BIN_GAUSS_BYTES = 37
TRAIN_KERNELS = ("project_fwd", "project_bwd", "bin_tiles", "blend_train_fwd", "blend_train_bwd",
                 "reduce_slots", "ssim_fwd", "ssim_bwd")
# a render without gradients: the projection's forward, the binning, then K3
RENDER_KERNELS = ("project_fwd", "bin_tiles", "tile_blend_fwd")
WRAPPERS = {f.__name__: f for f in T.KERNEL_WRAPPERS}


def in_turns(label, kernel, other):
    """Times two kernels on the same inputs in turns (other, kernel,
    kernel, other: medians of CUDA-event timings) and prints the times."""
    t = [cuda_ms(f, 20) for f in (other, kernel, kernel, other)]
    print(f"turns {label}: other {t[0]:.4f} ms, kernel {t[1]:.4f} ms, kernel {t[2]:.4f} ms, "
          f"other {t[3]:.4f} ms; kernel / other {(t[1] + t[2]) / (t[0] + t[3]):.3f}", flush=True)


def graph_ms(fn, reps: int, iters: int = 20) -> float:
    """Device milliseconds of one fn(): the median over `iters` replays
    (``cuda_ms``) of one CUDA graph of `reps` calls, over `reps`.  For a
    wrapper whose host dispatch outlasts its kernels, as it does inside
    the captured step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    ms = cuda_ms(g.replay, iters) / reps
    del g
    return ms


def launches_bitwise(name: str, label: str, fn, n: int = 3):
    """fn() (one kernel's wrapper on fixed inputs) n times: prints the run
    to run max |difference| and fails unless the n results are bitwise
    equal, as fixed-order sums make them; returns the first."""
    outs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    rr = max((o - outs[0]).abs().max().item() for o in outs[1:])
    same = all(torch.equal(o, outs[0]) for o in outs[1:])
    print(f"kernel {name} {label}: run to run max |difference| {rr:.3g} over {n} launches on "
          f"the same inputs (bitwise equal {same})", flush=True)
    if not same:
        fail(f"{name} ({label}) gave different bits on the same inputs")
    return outs[0]


def yardsticks(inputs, bg):
    """K1 and K2 against other kernels on the same inputs: K3 at (F, F, T)
    computes K1's function with the same cull and code in another kernel
    (bitwise, or fail), and K6b computes K2's accumulator through raw
    tile-local sums (held against K2 in ``basis_flavor``); each pair timed
    in turns."""
    fields, gidx, counts, col, finT, gc, gtt, _ = inputs
    H, W = col.shape
    col3, _, fin3, _ = TB.tile_blend_fwd(fields, gidx, counts, bg, H, W, False, False, True)
    torch.cuda.synchronize()
    same = torch.equal(col, col3) and torch.equal(finT, fin3)
    print(f"kernel blend_train_fwd against tile_blend_fwd (F, F, T): bitwise equal {same}",
          flush=True)
    if not same:
        fail("K1 and K3 at (F, F, T) disagree on the same inputs")
    in_turns("blend_train_fwd against tile_blend_fwd (F, F, T)",
             lambda: RC.blend_train_fwd(fields, gidx, counts, bg, H, W),
             lambda: TB.tile_blend_fwd(fields, gidx, counts, bg, H, W, False, False, True))
    in_turns("blend_train_bwd against blend_train_bwd_basis",
             lambda: RC.blend_train_bwd(*inputs), lambda: RC.blend_train_bwd_basis(*inputs))


def device_work(fn):
    """({node type: count} of the device work one call of fn enqueues, the
    launches the wrappers counted in that call).  The call is captured into
    a CUDA graph, never replayed, whose nodes ``graph_nodes`` reads."""
    fn()  # warm-up: every cached set-up of the wrapper happens outside the capture
    torch.cuda.synchronize()
    before = {n: w.launches for n, w in WRAPPERS.items()}
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    launches = {n: w.launches - before[n] for n, w in WRAPPERS.items() if w.launches != before[n]}
    out = graph_nodes(g)
    g.reset()
    return out, launches


def ssim_checks(a, b) -> None:
    """K7's and K8's launch shapes on a pair (blocks, blocks resident per
    SM, waves; K7's blocks must be the partial sums its wrapper allocates)
    and the device work one K7 call enqueues, which must be one kernel,
    launched by its wrapper (``device_work``)."""
    H, W = a.shape
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    for name in ("ssim_fwd", "ssim_bwd"):
        s = SC.launch_shape(name, H, W)
        print(f"launch {name} at {H}x{W}: {s['blocks']} blocks of {s['threads']} threads, "
              f"{s['smem']} B dynamic shared memory, {s['per_sm']} blocks per SM, "
              f"{s['blocks'] / (s['per_sm'] * nsm):.3f} waves on {nsm} SMs", flush=True)
        if s["blocks"] != -(-H // SC.TILE) * -(-W // SC.TILE):
            fail(f"{name} launches {s['blocks']} blocks, not one per {SC.TILE}x{SC.TILE} tile")
    nodes, launches = device_work(lambda: SC.ssim_fwd(a, b))
    print(f"one ssim_fwd call at {H}x{W} enqueues {nodes} (CUDA graph capture), wrapper "
          f"launches {launches}", flush=True)
    if nodes != {"kernel": 1} or launches != {"ssim_fwd": 1}:
        fail(f"one ssim_fwd call at {H}x{W} enqueued {nodes} with wrapper launches {launches}, "
             f"not one kernel launched by ssim_fwd")


# ops whose CUDA kernels add or write in no fixed order (atomics, or a
# write that repeated indices race for) unless
# torch.use_deterministic_algorithms swaps in another kernel, which it does
# without a warning; the flag warns (warn_only) only for ops it cannot swap.
# So the phase logs the ops the paths dispatch beside the flag's warnings.
NONDET_OPS = {
    "index_add", "index_put", "_index_put_impl", "_unsafe_index_put", "put", "index_copy",
    "index_reduce", "scatter", "scatter_add", "scatter_reduce", "embedding_dense_backward",
    "_embedding_bag_backward", "cumsum", "bincount", "histc", "grid_sampler_2d_backward",
    "upsample_bilinear2d_backward", "upsample_bicubic2d_backward", "upsample_linear1d_backward",
    "adaptive_avg_pool2d_backward", "adaptive_max_pool2d_backward", "avg_pool3d_backward",
    "max_pool3d_with_indices_backward", "reflection_pad1d_backward",
    "reflection_pad2d_backward", "replication_pad1d_backward", "replication_pad2d_backward",
    "nll_loss2d_forward", "_ctc_loss_backward", "median", "nanmedian", "kthvalue",
}
# each such op the step and render-gradient paths run, and why its result
# is the same in any order there
ORDER_FREE = {
    "cuBLAS": "cuBLAS GEMMs (mm, bmm, mv: the projection, the Bezier samples): a fixed "
              "reduction per shape, the same bits on every run while one stream runs cuBLAS "
              "(cuBLAS's reproducibility rule); the warning asks for CUBLAS_WORKSPACE_CONFIG, "
              "which matters only when streams run cuBLAS at once, never on these paths",
}

# comparisons of one step taken in two summation orders (ranks' partial
# sums against one process's): every state array no further than 2x a
# second step's distance from the first (0 when the sums run in a fixed
# order) plus the caller's tolerance of its max
RANKS_STATE_SLACK = 2.0
# and the losses of two runs of 20 such steps within 1e-4 relative
RANKS_CHUNK_TOL = 1e-4


def deterministic_ops(ts, cams, gts, opt_cfg, pipe_cfg, M) -> None:
    """Phase 5b of the module docstring: one eager step of each training
    path (the default flavor, the mask and connectivity terms on, the
    table, indirect and basis flavors) and the full-channel render's
    gradient under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` (set here only), logging every op they dispatch on
    the card; fails if one of NONDET_OPS or a warning of the flag is not in
    ORDER_FREE."""
    import warnings

    from torch.utils._python_dispatch import TorchDispatchMode

    found = {}

    class OpLog(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__.rstrip("_")
            cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
            if cuda and name in NONDET_OPS:
                if name.startswith("index_put") or name == "_index_put_impl":
                    acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
                    key = f"index_put accumulate={bool(acc)}"
                elif name == "cumsum":
                    dt = kwargs.get("dtype") or args[0].dtype
                    key = "cumsum " + ("float" if dt.is_floating_point else "int")
                else:
                    key = name
                found[key] = found.get(key, 0) + 1
            return func(*args, **kwargs)

    kw = dict(n_gaussians=M)
    state = cs.curve_state_of(ts)

    def gradient():
        g = cs.gaussians(state)
        leaves = [g[k].detach().requires_grad_(True) for k in ("xyz", "scale", "quat", "opacity")]
        out = render(*leaves, cams[0], alive=g["alive"], capacity=pipe_cfg.tile_capacity,
                     big_capacity=pipe_cfg.big_capacity)
        total = sum(out[k].sum() for k in ("render", "invdepth", "alpha", "dir"))
        return torch.autograd.grad(total, leaves)

    paths = [("step", lambda: T.train_step(ts, cams[0], gts[0], 0.0, opt_cfg, pipe_cfg,
                                           use_mask=False, **kw)),
             ("step with mask and connectivity",
              lambda: T.train_step(ts, cams[1], gts[1], 0.0, opt_cfg, pipe_cfg, use_mask=True,
                                   conn_on=True, **kw)),
             ("full-channel gradient", gradient)]
    old = os.environ.get("CGT_BLEND_FLAVOR")
    warned = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with OpLog():
                for name, fn in paths:
                    fn()
                for flavor in ("table", "indirect", "basis"):
                    os.environ["CGT_BLEND_FLAVOR"] = flavor
                    T.train_step(ts, cams[2], gts[2], 0.0, opt_cfg, pipe_cfg, use_mask=False,
                                 **kw)
            torch.cuda.synchronize()
        warned = sorted({str(x.message).splitlines()[0][:200] for x in w})
    finally:
        torch.use_deterministic_algorithms(False)
        if old is None:
            os.environ.pop("CGT_BLEND_FLAVOR", None)
        else:
            os.environ["CGT_BLEND_FLAVOR"] = old
    flagged = dict(found)
    for msg in warned:
        key = "cuBLAS" if "CuBLAS" in msg or "cuBLAS" in msg else msg
        flagged[key] = flagged.get(key, 0) + 1
    print(f"deterministic algorithms (warn_only) over {[n for n, _ in paths]} and the table, "
          f"indirect and basis flavors' steps: ops of no fixed order dispatched {found}; the "
          f"flag's warnings {warned}", flush=True)
    for key, n in flagged.items():
        print(f"  {key} ({n}): {ORDER_FREE.get(key, 'NOT SHOWN ORDER-FREE')}", flush=True)
    bad = sorted(k for k in flagged if k not in ORDER_FREE)
    if bad:
        fail(f"ops of no fixed order on the step and render-gradient paths: {bad}")


def state_differences(a, b) -> dict:
    """{leaf: max |a - b|} over two TrainStates' arrays (0.0 where bitwise
    equal, inf where the shapes differ)."""
    la, lb = T._state_leaves(a), T._state_leaves(b)
    return {k: 0.0 if torch.equal(v, lb[k]) else np.inf if v.shape != lb[k].shape
            else (v.double() - lb[k].double()).abs().max().item() for k, v in la.items()}


def nonzero(diffs: dict) -> dict:
    return {k: v for k, v in diffs.items() if v != 0.0}


def graphed_step(ts, cams, gts, opt_cfg, pipe_cfg, M, profile=False):
    """Phases 5 (the graphed step) and 6 of the module docstring, from the
    state after the main path's eager steps."""
    H, W = cams[0].height, cams[0].width
    dev = gts[0].device
    stacks = T.camera_stacks(cams, torch.float32, dev)
    gt_stack = torch.stack(gts)
    geom = (H, W, cams[0].tanfovx, cams[0].tanfovy)
    kw = dict(use_mask=False, n_gaussians=M)
    graphs = T.StepGraphs()

    def graphed(rows):
        return T.train_steps_scan(ts, stacks, gt_stack, 0.0, opt_cfg, pipe_cfg, cam_geom=geom,
                                  rows=rows, graphs=graphs, **kw)

    def eager(rows):
        return T.train_steps(ts, [cams[r] for r in rows], [gts[r] for r in rows], 0.0,
                             opt_cfg, pipe_cfg, **kw)

    # -- the capture, one step ------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g1, mg = graphed([0])
    torch.cuda.synchronize()
    peak_capture = torch.cuda.max_memory_allocated()
    (cap,) = graphs.captures
    nodes = graph_nodes(graphs.latest_graph())
    eager_nodes, _ = device_work(lambda: T.train_step(ts, cams[0], gts[0], 0.0, opt_cfg,
                                                      pipe_cfg, **kw))
    print(f"graphed step: capture {cap['seconds']:.3f} s (host clock: {T.WARMUP_STEPS} eager "
          f"warm-up step {cap['warmup_seconds']:.3f}, the capture {cap['capture_seconds']:.3f}, "
          f"instantiation {cap['instantiate_seconds']:.3f}), wrapper launches in the capture "
          f"{cap['launches']}; the captured step's nodes {nodes}; one eager step captured the "
          f"same way {eager_nodes}; peak memory over the capture {peak_capture / 2**30:.3f} "
          f"GiB", flush=True)
    if cap["launches"] != {n: 1 for n in TRAIN_KERNELS}:
        fail(f"the captured step launched {cap['launches']}, not {', '.join(TRAIN_KERNELS)} "
             f"once each")
    if nodes.get("host", 0) or nodes.get("memcpy_from_host", 0) or not nodes.get("kernel"):
        fail(f"the captured step holds host work or copies from host memory: {nodes}")

    # -- one step from the same state (neither function modifies its input) -----------
    e1, m1 = eager([0])
    torch.cuda.synchronize()
    loss_g, loss_e = float(mg["total"][0]), float(m1[0]["total"])

    def grad(t, k):
        return (t.opt.mu[k] - optim.B1 * ts.opt.mu[k]) / (1 - optim.B1)

    grad_diff = {k: (grad(g1, k) - grad(e1, k)).abs().max().item() for k in ts.params
                 if k not in T.dead_groups(False)}
    state_diff = state_differences(g1, e1)
    print(f"graphed step against eager, one step: loss {loss_g!r} vs {loss_e!r}; max |graphed - "
          f"eager| of each group's gradient (from Adam's first moment) {grad_diff}; of the "
          f"post-Adam state, nonzero: {nonzero(state_diff)} (bitwise: the sums run in a fixed "
          f"order)", flush=True)
    if loss_g != loss_e or any(grad_diff.values()) or nonzero(state_diff):
        fail("the graphed step is not bitwise equal to the eager step from the same state")

    # -- 25 steps ---------------------------------------------------------------------
    rows = [i % len(cams) for i in range(25)]
    g25, mg25 = graphed(rows)
    e25, me25 = eager(rows)
    lg = mg25["total"].cpu().numpy()
    le = np.array([float(m["total"]) for m in me25])
    d25 = nonzero(state_differences(g25, e25))
    print(f"graphed chunk against eager, 25 steps: losses first {lg[0]:.6f} vs {le[0]:.6f}, "
          f"last {lg[-1]:.6f} vs {le[-1]:.6f}; losses that differ {int((lg != le).sum())}, "
          f"state arrays that differ {d25}", flush=True)
    if (lg != le).any() or d25:
        fail("the graphed chunk of 25 steps is not bitwise equal to 25 eager steps")

    # -- timing in turns -----------------------------------------------------------------
    rows = [i % len(cams) for i in range(20)]

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        fn(rows)
        torch.cuda.synchronize()
        return (time.time() - t0) / len(rows), torch.cuda.max_memory_allocated()

    turns = [("eager", timed(eager)), ("graphed", timed(graphed)), ("graphed", timed(graphed)),
             ("eager", timed(eager))]
    for name, (dt, peak) in turns:
        print(f"turn {name}: {dt * 1e3:.3f} ms/step, {1 / dt:.3f} steps/s, "
              f"{H * W / dt / 1e6:.3f} Mpix/s fwd+bwd (20 steps, host clock), peak memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
    mean = {n: np.mean([dt for m, (dt, _) in turns if m == n]) for n in ("eager", "graphed")}
    print(f"graphed step: {mean['graphed'] * 1e3:.3f} ms/step against eager "
          f"{mean['eager'] * 1e3:.3f} ({mean['eager'] / mean['graphed']:.2f}x), device time "
          f"{replay_ms(graphs):.3f} ms (CUDA events around one replay), captures "
          f"{len(graphs.captures)} in {graphs.capture_seconds:.3f} s, memory reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB (the graph pool included)",
          flush=True)
    if profile:
        profile_step(lambda: graphed([i % len(cams) for i in range(10)]), 10,
                     "graphed bench step")
    graphs.release()


# the view-batched step (B views per optimizer step): B = 2 and 4 over the
# bench views, 20 steps a timed chunk; one graphed step against the same
# step run eagerly (bitwise), and against Adam applied to the mean of B
# step_grads (another order of operations around the same sums): the loss
# within 1e-6 relative, every state array within 1e-6 of its max
VIEW_BATCHES = (2, 4)
VIEW_STEPS = 20
VIEW_TOL = 1e-6


def replay_ms(graphs) -> float:
    """Device milliseconds of one replay of the graph captured last (CUDA
    events around it, median of 20; the step counter reset before each)."""
    g, b = graphs.latest_graph(), graphs._bufs
    return cuda_ms(lambda _: g.replay(), 20, setup=lambda: b.counter.zero_())


def mean_grads_step(ts, cams, gts, views, opt_cfg, pipe_cfg, M):
    """The B-view step written out: B ``step_grads`` calls, their mean
    gradient through ``optim.adam_update`` at the rates of ``ts.step``, and
    the statistics; returns (the state's leaves, the mean loss)."""
    sums = None
    for v in views:
        _, aux, grads, goff, vis, rad, _ = T.step_grads(ts, cams[v], gts[v], 0.0, opt_cfg,
                                                        pipe_cfg, use_mask=False, n_gaussians=M)
        if sums is None:
            sums = [{k: torch.zeros_like(g) for k, g in grads.items()}, torch.zeros_like(goff),
                    0.0, torch.zeros_like(vis), torch.zeros_like(rad)]
        sums = [{k: sums[0][k] + g for k, g in grads.items()}, sums[1] + goff,
                sums[2] + float(aux["total"]), sums[3] | vis, torch.maximum(sums[4], rad)]
    B = len(views)
    grads, goff, total, vis, rad = sums
    params, opt = optim.adam_update(ts.params, {k: g / B for k, g in grads.items()}, ts.opt,
                                    optim.group_lrs(opt_cfg, ts.step))
    H, W = cams[0].height, cams[0].width
    gnorm = (goff / B * torch.tensor([0.5 * W, 0.5 * H], device=goff.device)).norm(dim=-1)
    leaves = {**{f"params/{k}": v for k, v in params.items()},
              **{f"mu/{k}": v for k, v in opt.mu.items()},
              **{f"nu/{k}": v for k, v in opt.nu.items()},
              "xyz_grad_accum": ts.xyz_grad_accum + gnorm * vis,
              "denom": ts.denom + vis.to(ts.denom.dtype),
              "max_radii": torch.maximum(ts.max_radii, torch.where(vis, rad, 0))}
    return leaves, total / B


def view_batches(ts, cams, gts, opt_cfg, pipe_cfg, M, smi: str):
    """Phase 6b of the module docstring, from the state after the main
    path's eager steps."""
    H, W = cams[0].height, cams[0].width
    dev = gts[0].device
    nv = len(cams)
    stacks = T.camera_stacks(cams, torch.float32, dev)
    gt_stack = torch.stack(gts)
    geom = (H, W, cams[0].tanfovx, cams[0].tanfovy)
    one = T.StepGraphs()

    def single(rows):
        return T.train_steps_scan(ts, stacks, gt_stack, 0.0, opt_cfg, pipe_cfg, use_mask=False,
                                  n_gaussians=M, cam_geom=geom, rows=rows, graphs=one)

    single([0])  # the one-view capture, outside the turns
    one_ms = replay_ms(one)
    for B in VIEW_BATCHES:
        graphs = T.StepGraphs(PS._local_batch_step)
        table = [[(i * B + j) % nv for j in range(B)] for i in range(VIEW_STEPS)]

        def batched(tab):
            return PS.parallel_train_steps_scan(ts, stacks, gt_stack, 0.0, opt_cfg, pipe_cfg,
                                                use_mask=False, mesh_shape=None, cam_geom=geom,
                                                rows=tab, graphs=graphs)

        # -- the capture: one step, K1, K2, K7 and K8 B times each, no host work --------
        (g1, mg), counts = run_path(f"B={B} graphed step", lambda: batched(table[:1]),
                                    TRAIN_KERNELS)
        check_step_launches(f"B={B} graphed step", counts, graphs, 1, {}, views=B)
        nodes = graph_nodes(graphs.latest_graph())
        print(f"B={B} graphed step: the captured step's nodes {nodes}", flush=True)
        if nodes.get("host", 0) or nodes.get("memcpy_from_host", 0) or not nodes.get("kernel"):
            fail(f"the B={B} captured step holds host work or copies from host memory: {nodes}")

        # -- against the same step eagerly, and against the mean of B step_grads ------------
        row = table[0]

        def eager():
            return PS.parallel_train_step(ts, tuple(s[row] for s in stacks), gt_stack[row], 0.0,
                                          opt_cfg, pipe_cfg, use_mask=False, mesh_shape=None,
                                          cam_geom=geom)

        e1, m1 = eager()
        mean_leaves, mean_loss = mean_grads_step(ts, cams, gts, row, opt_cfg, pipe_cfg, M)
        torch.cuda.synchronize()
        loss_g = float(mg["total"][0])
        eager_diff = nonzero(state_differences(g1, e1))
        mean_err = abs(loss_g - mean_loss) / abs(mean_loss)
        gl = T._state_leaves(g1)
        worst = []
        for k, ref in mean_leaves.items():
            d = (gl[k].double() - ref.double()).abs().max().item()
            bound = VIEW_TOL * ref.double().abs().max().item()
            worst.append((d / bound if bound > 0 else (0.0 if d == 0 else np.inf), k, d, bound))
        worst.sort(key=lambda w: -w[0])
        print(f"B={B} graphed step against eager: loss {loss_g!r} vs {float(m1['total'])!r}, "
              f"state arrays that differ {eager_diff} (bitwise); against the mean of {B} "
              f"step_grads (an Adam step by hand): loss error over value {mean_err:.3g} (tol "
              f"{VIEW_TOL:g}), state, worst (max |graphed - ref| over its bound): " + ", ".join(
                  f"{k} {d:.3g}/{b:.3g}" for _, k, d, b in worst[:6]), flush=True)
        if loss_g != float(m1["total"]) or eager_diff:
            fail(f"the B={B} graphed step is not bitwise equal to the same step run eagerly")
        if mean_err > VIEW_TOL:
            fail(f"the B={B} graphed step's loss disagrees with the mean of step_grads': "
                 f"{mean_err}")
        if worst[0][0] > 1.0:
            fail(f"the B={B} graphed step's {worst[0][1]} is further than {VIEW_TOL:g} of max "
                 "from the mean of step_grads")

        # -- timing in turns against one-view graphed steps over the same views -----------
        flat = [v for r in table for v in r]

        def timed(fn, arg):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            fn(arg)
            torch.cuda.synchronize()
            return time.time() - t0, torch.cuda.max_memory_allocated()

        turns = [("one-view", timed(single, flat)), (f"B={B}", timed(batched, table)),
                 (f"B={B}", timed(batched, table)), ("one-view", timed(single, flat))]
        for name, (dt, peak) in turns:
            steps = len(flat) if name == "one-view" else len(table)
            print(f"turn {name}: {dt / steps * 1e3:.3f} ms/step, {dt / len(flat) * 1e3:.3f} "
                  f"ms/view ({steps} steps, {len(flat)} views, host clock), peak memory "
                  f"{peak / 2**30:.3f} GiB", flush=True)
        b_ms = replay_ms(graphs)
        per_view = {n: np.mean([dt for m, (dt, _) in turns if m == n]) / len(flat)
                    for n in ("one-view", f"B={B}")}
        print(f"B={B} graphed step: {per_view[f'B={B}'] * B * 1e3:.3f} ms/step, "
              f"{per_view[f'B={B}'] * 1e3:.3f} ms/view against one-view graphed "
              f"{per_view['one-view'] * 1e3:.3f} ms/view (host clock, mean of two turns); "
              f"device time per step {b_ms:.3f} ms ({b_ms / B:.3f} ms/view) against one-view "
              f"{one_ms:.3f} ms (CUDA events around one replay); capture "
              f"{graphs.capture_seconds:.3f} s; {smi}", flush=True)
        graphs.release()
    one.release()


def device_launches(counts: dict, *graphs) -> dict:
    """The launches on the device from the wrappers' host counts: a
    captured launch counts once on the host, so the counts less those of
    each of `graphs`' captures plus each capture's times its replays."""
    out = dict(counts)
    for g in graphs:
        captured, replayed = g.captured_launches(), g.replayed_launches()
        out = {n: v - captured.get(n, 0) + replayed.get(n, 0) for n, v in out.items()}
    return out


def check_render_graphs(label: str, rg, n_views: int) -> int:
    """Every capture of the render graphs `rg` must hold K3 once and
    nothing else, and their replays must be the `n_views` views rendered;
    prints each capture and returns the number of captures (each made one
    eager warm-up render)."""
    for c in rg.captures:
        print(f"{label} render capture: {c['baked']} {c['views']} views of {c['height']}x"
              f"{c['width']}: {c['seconds']:.3f} s (warm-up {c['warmup_seconds']:.3f}, capture "
              f"{c['capture_seconds']:.3f}, instantiation {c['instantiate_seconds']:.3f}), "
              f"{c['replays']} replays, launches {c['launches']}", flush=True)
        if c["launches"] != {n: 1 for n in RENDER_KERNELS}:
            fail(f"a {label} render capture launched {c['launches']}, not "
                 f"{', '.join(RENDER_KERNELS)} once")
    replays = sum(c["replays"] for c in rg.captures)
    if replays != n_views:
        fail(f"the {label} replayed its render graphs {replays} times, not {n_views}")
    return len(rg.captures)


def check_step_launches(label: str, counts: dict, graphs, steps: int, eager: dict,
                        views: int = 1, renders=None) -> None:
    """The launch checks of a run through ``train_scene``'s step graphs
    (``device_launches``).  Every capture must hold the projection's two
    kernels, K1, K2, K7 and K8 `views` times each (once per view of a
    step) and nothing else, the replays must be the run's steps, and those
    kernels must have run `views` times per step and per warm-up step on
    the device; `eager` gives the other kernels' launches.  `renders` =
    (the run's render graphs, the test views it rendered): their captures
    and replays are checked (``check_render_graphs``), and K3 must have
    run once per rendered view and per warm-up render besides `eager`'s,
    and the projection's forward once more per K3 launch."""
    device = device_launches(counts, graphs, *([renders[0]] if renders else []))
    if renders:
        warm = check_render_graphs(label, *renders)
        eager = dict(eager, tile_blend_fwd=eager.get("tile_blend_fwd", 0) + renders[1] + warm)
    replays = sum(c["replays"] for c in graphs.captures)
    print(f"{label}: {len(graphs.captures)} step captures in {graphs.capture_seconds:.3f} s "
          f"(host clock, {graphs.warmup_steps} warm-up steps), {replays} replays; launches "
          f"on the device {device}", flush=True)
    for c in graphs.captures:
        print(f"{label} capture: capacity {c['capacity']} K {c['tile_capacity']} big "
              f"{c['big_capacity']} views {c['views']} mask {c['use_mask']} connectivity "
              f"{c['conn_on']}: "
              f"{c['seconds']:.3f} s (warm-up {c['warmup_seconds']:.3f}, capture "
              f"{c['capture_seconds']:.3f}, instantiation {c['instantiate_seconds']:.3f}), "
              f"{c['replays']} replays, launches {c['launches']}", flush=True)
        if c["launches"] != {n: views for n in TRAIN_KERNELS}:
            fail(f"a {label} capture launched {c['launches']}, not "
                 f"{', '.join(TRAIN_KERNELS)} {views} times each")
    if replays != steps:
        fail(f"the {label} replayed its step graphs {replays} times, not {steps}")
    want = {n: views * (steps + graphs.warmup_steps) for n in TRAIN_KERNELS}
    for n, v in eager.items():
        want[n] = want.get(n, 0) + v
    # every render outside the step (an expected K3 launch) projects and bins its
    # Gaussians once
    for n in ("project_fwd", "bin_tiles"):
        want[n] += want.get("tile_blend_fwd", 0)
    for n, v in want.items():
        if device[n] != v:
            fail(f"the {label} launched {n} {device[n]} times on the device, not {v}")


def run_path(name: str, fn, must: tuple, must_not: tuple = ()):
    """Drive one path with every launch counter set to 0 just before it;
    returns (fn's result, the counts read just after).  Fails unless each
    kernel in `must` launched and none in `must_not` did."""
    for w in WRAPPERS.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in WRAPPERS.items()}
    print(f"path {name}: launches {counts}", flush=True)
    for n in must:
        if counts[n] <= 0:
            fail(f"kernel {n} was not launched by the {name} path")
    for n in must_not:
        if counts[n] != 0:
            fail(f"kernel {n} was launched by the {name} path, which routes elsewhere")
    return out, counts


def k3_entry(label, fields, b, H, W, geo, invd, ones, pairs=None):
    """K3 at one channel set against its plain version (bitwise, or fail),
    timed beside its bound; returns (its kernel entry, its outputs, the pair
    counts)."""
    gidx, counts = b.gather_idx, b.counts
    bg = torch.zeros(1, device=fields.device)
    outs = TB.tile_blend_fwd(fields, gidx, counts, bg, H, W, geo, invd, ones)
    outs_p = TB.tile_blend_fwd_plain(fields, gidx, counts, bg, H, W, geo, invd, ones)
    torch.cuda.synchronize()
    n_inst, P1 = int(counts.sum()), fields.shape[0]
    ngch = sum(c is not None for _, c in TB.channels(geo, invd, ones))
    pairs = pair_counts(fields, gidx, counts, H, W) if pairs is None else pairs
    # bytes: K3 writes all 7 output images (a gated channel's zeros too);
    # accumulated channels: those with a field (the ones colour derives from T)
    tables = P1 * fields.shape[1] * 4 + n_inst * 4 + gidx.shape[0] * 4
    b3, by3 = blend_bound(tables + 4 + 7 * H * W * 4, pairs, k3_ops(ngch))
    k = dict(
        name="tile_blend_fwd", route="cuda", source=BLEND_SRC,
        replaces="curve_gaussian_tpu/ops/rasterize_pallas.py:368", launches=0,
        max_abs_err=max((o - p).abs().max().item() for o, p in zip(outs, outs_p)),
        rel_err=max(rel_err(o, p) for o, p in zip(outs, outs_p)),
        ms=cuda_ms(lambda: TB.tile_blend_fwd(fields, gidx, counts, bg, H, W, geo, invd, ones),
                   20),
        plain_ms=cuda_ms(lambda: TB.tile_blend_fwd_plain(fields, gidx, counts, bg, H, W, geo,
                                                         invd, ones), 3),
        bound_ms=b3, bound_by=by3, library_ms=None,
    )
    report(k, f"{label} (geo, invd, ones)={(geo, invd, ones)} H,W={H},{W} "
              f"T={gidx.shape[0]} K={gidx.shape[1]} P1={P1} instances={n_inst} "
              f"{pairs_note(pairs)}")
    print(f"kernel tile_blend_fwd {label}: {cull_note(pairs, counts, 'K3')}", flush=True)
    if not all(torch.equal(o, p) for o, p in zip(outs, outs_p)):
        fail(f"K3 is not equal to its plain version on the {label} inputs")
    return k, outs, pairs


def tile_kernels(label, fields, b, H, W, geo, invd, ones, cots):
    """K3 (bitwise) and K4 at one channel set against their plain versions,
    timed, K4 three times on the same inputs (bitwise equal); returns their
    two kernel entries."""
    gidx, counts = b.gather_idx, b.counts
    fwd, outs, pairs = k3_entry(label, fields, b, H, W, geo, invd, ones)
    dpay = launches_bitwise("tile_blend_bwd", f"{label} {(geo, invd, ones)}",
                            lambda: TB.tile_blend_bwd(fields, gidx, counts, outs, cots, geo, invd,
                                                      ones))
    dpay_p = TB.tile_blend_bwd_plain(fields, gidx, counts, outs, cots, geo, invd, ones)
    torch.cuda.synchronize()
    n_inst, P1, nf = int(counts.sum()), fields.shape[0], fields.shape[1]
    chans = TB.channels(geo, invd, ones)
    nch, ngch = len(chans), sum(c is not None for _, c in chans)
    # bytes: K4 needs only the images of the set's channels and their cotangents
    nimg = 2 + (1 if invd else 0) + (4 if geo else 0)
    tables = P1 * nf * 4 + n_inst * 4 + gidx.shape[0] * 4
    b4, by4 = blend_bound(tables + 2 * nimg * H * W * 4 + dpay.numel() * 4, pairs,
                          k4_ops(nch, ngch))
    bwd = dict(
        name="tile_blend_bwd", route="cuda", source=BLEND_SRC,
        replaces="curve_gaussian_tpu/ops/rasterize_pallas.py:483", launches=0,
        max_abs_err=(dpay - dpay_p).abs().max().item(), rel_err=rel_err(dpay, dpay_p),
        ms=cuda_ms(lambda: TB.tile_blend_bwd(fields, gidx, counts, outs, cots, geo, invd, ones),
                   20),
        plain_ms=cuda_ms(lambda: TB.tile_blend_bwd_plain(fields, gidx, counts, outs, cots, geo,
                                                         invd, ones), 3),
        bound_ms=b4, bound_by=by4, library_ms=None,
    )
    report(bwd, f"{label} (geo, invd, ones)={(geo, invd, ones)} H,W={H},{W} "
                f"T={gidx.shape[0]} K={gidx.shape[1]} P1={P1} instances={n_inst} "
                f"{pairs_note(pairs)}")
    print(f"kernel tile_blend_bwd {label}: {cull_note(pairs, counts, 'K4')}", flush=True)
    return fwd, bwd


def report(k, label=""):
    print(f"kernel {k['name']} {label}: max_abs_err {k['max_abs_err']:.3g} rel "
          f"{k['rel_err']:.3g} (tol {TOL[k['name']]:g}); {k['ms']:.4f} ms, plain "
          f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), "
          f"library {k['library_ms']}", flush=True)
    if not (k["rel_err"] <= TOL[k["name"]]):
        fail(f"{k['name']} {label} disagrees with its plain version: "
             f"{k['rel_err']} > {TOL[k['name']]}")


# the graphed eval render against the eager one: render, invdepth, alpha and
# final_T bitwise (K3 and the sort are deterministic); dir within 1e-6 of its
# max, since its einsum may take another cuBLAS kernel under capture
RENDER_DIR_TOL = 1e-6


def render_turns(label: str, ts, cams, pipe_cfg, smi: str) -> int:
    """Phases 7b and 10e of the module docstring: ``eval_renders`` of
    `cams` (their views captured as one CUDA graph and replayed) against
    ``eval_render`` of each, then in turns; returns K3's launches on the
    device in the graphed path's first call (one per view and one warm-up
    render)."""
    H, W = cams[0].height, cams[0].width
    stacks = T.camera_stacks(cams, torch.float32, ts.alive.device)
    geom = (H, W, cams[0].tanfovx, cams[0].tanfovy)
    views = list(range(len(cams)))
    rg = T.RenderGraphs()

    def graphed(full=()):
        return T.eval_renders(ts, stacks, geom, pipe_cfg, 0.0, views, graphs=rg, full=full)

    def eager(keep_maps=False):  # the driver's eager loop held one view's maps at a time
        renders, maps = [], {}
        for v, cam in enumerate(cams):
            with torch.no_grad():
                out = T.eval_render(ts, cam, pipe_cfg, 0.0)
            renders.append(out["render"])
            if keep_maps:
                maps[v] = out
        return torch.stack(renders), maps

    # -- the capture, in the first call: K3 once, no host work --------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (g_stack, g_maps), c = run_path(f"{label} graphed eval render", lambda: graphed(views),
                                    RENDER_KERNELS,
                                    tuple(n for n in WRAPPERS if n not in RENDER_KERNELS))
    peak_capture = torch.cuda.max_memory_allocated()
    (cap,) = rg.captures
    r = rg.latest()
    nodes = graph_nodes(r.graph)
    k3 = device_launches(c, rg)["tile_blend_fwd"]
    print(f"{label} graphed eval render: {len(views)} views of {H}x{W}, capture "
          f"{cap['seconds']:.3f} s (host clock: an eager warm-up render "
          f"{cap['warmup_seconds']:.3f}, the capture {cap['capture_seconds']:.3f}, "
          f"instantiation {cap['instantiate_seconds']:.3f}), wrapper launches in the capture "
          f"{cap['launches']}, K3 on the device {k3}; graph_nodes {nodes}; peak memory over the "
          f"first call {peak_capture / 2**30:.3f} GiB", flush=True)
    if cap["launches"] != {n: 1 for n in RENDER_KERNELS} or k3 != len(views) + 1:
        fail(f"the {label} render capture launched {cap['launches']} and K3 ran {k3} times on "
             f"the device, not once and {len(views)} + 1")
    if nodes.get("host", 0) or nodes.get("memcpy_from_host", 0) or not nodes.get("kernel"):
        fail(f"the {label} captured render holds host work or copies from host memory: {nodes}")

    # -- against the eager render of each view ----------------------------------------
    e_stack, e_maps = eager(keep_maps=True)
    torch.cuda.synchronize()
    same = {k: all(torch.equal(g_maps[v][k], e_maps[v][k]) for v in views)
            for k in T.EVAL_MAPS if k != "dir"}
    same["stack"] = torch.equal(g_stack, e_stack)
    dir_err = max(rel_err(g_maps[v]["dir"], e_maps[v]["dir"]) for v in views)
    dir_same = all(torch.equal(g_maps[v]["dir"], e_maps[v]["dir"]) for v in views)
    print(f"{label} graphed eval render against eval_render of each view: bitwise {same}; dir "
          f"bitwise {dir_same}, error over max {dir_err:.3g} (tol {RENDER_DIR_TOL:g})", flush=True)
    if not all(same.values()) or dir_err > RENDER_DIR_TOL:
        fail(f"the {label} graphed eval render disagrees with eval_render")

    # -- in turns (eager, graphed, graphed, eager) ----------------------------------------
    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return (time.time() - t0) / len(views), torch.cuda.max_memory_allocated()

    map0 = g_maps[0]
    del e_stack, e_maps, g_stack, g_maps  # out of the turns' peaks
    turns = [("eager", timed(eager)), ("graphed", timed(graphed)), ("graphed", timed(graphed)),
             ("eager", timed(eager))]
    for name, (dt, peak) in turns:
        print(f"{label} render turn {name}: {dt * 1e3:.3f} ms/view ({len(views)} views of "
              f"{H}x{W}, host clock), peak memory {peak / 2**30:.3f} GiB", flush=True)
    mean = {n: np.mean([dt for m, (dt, _) in turns if m == n]) for n in ("eager", "graphed")}
    rep_ms = cuda_ms(lambda _: r.graph.replay(), 20, setup=lambda: r.bufs.counter.zero_())
    print(f"{label} graphed eval render: {mean['graphed'] * 1e3:.3f} ms/view against eager "
          f"{mean['eager'] * 1e3:.3f} ({mean['eager'] / mean['graphed']:.2f}x, host clock); "
          f"replay_ms {rep_ms:.4f} (CUDA events around one replay); capture "
          f"{rg.capture_seconds:.3f} s; graph_nodes {nodes}; {smi}", flush=True)
    rg.release()

    # what else a test render costs the driver: the stack's copy to the host and the
    # debug PNGs of one view (train_scene writes them for views 0-4)
    from curve_gaussian_tpu_torch.engine.loop import save_debug_images

    stack, _ = graphed()
    torch.cuda.synchronize()
    t0 = time.time()
    host = stack.cpu().numpy()
    t1 = time.time()
    save_debug_images(map0, host[0], os.path.join(DRIVER_DIR, "debug_png"), 0, 0)
    print(f"{label} test render extras: the [{len(views)}, {H}, {W}] stack to the host "
          f"{(t1 - t0) * 1e3:.3f} ms; one view's 5 debug PNGs {(time.time() - t1) * 1e3:.3f} ms "
          f"(host clock)", flush=True)
    return k3


def full_channel(ts, cams, gts, opt_cfg, pipe_cfg, M, dev, smi: str):
    """Phase 7 of the module docstring; returns the K3, K4 and K5 entries
    (K3 and K4 at the eval render's channel set)."""
    H, W = cams[0].height, cams[0].width
    state = cs.curve_state_of(ts)
    gen = torch.Generator(dev).manual_seed(2)

    # -- a. K3, K4, K5 against their plain versions ------------------------------
    fields, b = tile_inputs(state, cams[0], pipe_cfg, True, True, True)
    cots = tuple(torch.randn(s, device=dev, generator=gen)
                 for s in ((H, W), (H, W), (H, W), (4, H, W)))
    k3, k4 = tile_kernels("eval render", fields, b, H, W, True, True, True, cots)

    fields8, b8 = tile_inputs(state, cams[0], pipe_cfg, False, False, True, slots=True)
    col, finT = RC.blend_train_fwd(fields8, b8.gather_idx, b8.counts, torch.zeros(1, device=dev),
                                   H, W)
    img = col.clone().requires_grad_(True)
    with torch.enable_grad():  # the image loss's gradient at this render
        lo = L.edge_aware_loss(img, gts[0]) + (1.0 - SC.ssim_fused(img, gts[0]))
        (gc,) = torch.autograd.grad(lo, img)
    gc = gc.contiguous()
    gtt = (torch.randn(H, W, device=dev, generator=gen) * gc.abs().max()).contiguous()
    zeros = torch.zeros_like(gc)
    tile_kernels("table flavor", fields8, b8, H, W, False, False, True,
                 (gc, zeros, gtt, torch.zeros((4, H, W), device=dev)))
    gidx, counts = b8.gather_idx, b8.counts
    ins8 = (fields8, gidx, counts, col, finT, gc, gtt)
    mom = launches_bitwise("blend_moment_bwd", "indirect flavor",
                           lambda: TB.blend_moment_bwd(*ins8))
    mom_p = TB.blend_moment_bwd_plain(*ins8)
    acc2 = RC.blend_train_bwd(*ins8, b8.slots)
    torch.cuda.synchronize()
    n_inst = int(counts.sum())
    pairs8 = pair_counts(fields8, gidx, counts, H, W)
    b5, by5 = blend_bound(fields8.numel() * 4 + n_inst * 4 + gidx.shape[0] * 4 + 4 * H * W * 4
                          + mom.numel() * 4, pairs8, MOMENT_OPS)
    k5 = dict(
        name="blend_moment_bwd", route="cuda", source=BLEND_SRC,
        replaces="curve_gaussian_tpu/ops/rasterize_pallas.py:656", launches=0,
        max_abs_err=(mom - mom_p).abs().max().item(), rel_err=rel_err(mom, mom_p),
        ms=cuda_ms(lambda: TB.blend_moment_bwd(*ins8), 20),
        plain_ms=cuda_ms(lambda: TB.blend_moment_bwd_plain(*ins8), 3),
        bound_ms=b5, bound_by=by5, library_ms=None,
    )
    report(k5, f"indirect flavor (F, F, T) {pairs_note(pairs8)}")
    print(f"kernel blend_moment_bwd indirect flavor: {cull_note(pairs8, counts, 'K5')}",
          flush=True)
    same52 = torch.equal(RC.reduce_slots(mom, b8.slots, fields8.shape[0]), acc2)
    print(f"kernel blend_moment_bwd against K2 (its rows through reduce_slots, K2's kernel "
          f"and reduction): bitwise equal {same52}", flush=True)
    if not same52:
        fail("K5's rows through reduce_slots are not K2's accumulator on the same inputs")
    in_turns("blend_moment_bwd against blend_train_bwd (indirect flavor's inputs)",
             lambda: TB.blend_moment_bwd(*ins8), lambda: RC.blend_train_bwd(*ins8, b8.slots))

    # a per-splat colour, small scene (as small_check's)
    Hs = Ws = 96
    rng = np.random.default_rng(1)
    st = cs.init_state(rng.uniform(0.2, 0.8, size=(24, 3)).astype(np.float32), n_views=1,
                       n_gaussians=6, device=dev)
    cam_s = synthetic.ring_cameras(1, Hs, Ws, device=dev)[0]
    color = 0.2 + 0.8 * torch.rand(st.capacity * 6, device=dev, generator=gen)
    small = PipelineConfig(tile_capacity=256, big_capacity=64)
    fs, bs = tile_inputs(st, cam_s, small, True, True, False, color=color)
    cots_s = tuple(torch.randn(s, device=dev, generator=gen)
                   for s in ((Hs, Ws), (Hs, Ws), (Hs, Ws), (4, Hs, Ws)))
    tile_kernels("per-splat colour", fs, bs, Hs, Ws, True, True, False, cots_s)

    # -- b. eval render of each view -------------------------------------------
    def evals():
        with torch.no_grad():
            t0 = time.time()
            outs = [T.eval_render(ts, cam, pipe_cfg, 0.0) for cam in cams]
            torch.cuda.synchronize()
            return outs, (time.time() - t0) / len(cams)

    (outs, eval_s), c_eval = run_path("eval render", evals, ("tile_blend_fwd",),
                                      ("blend_train_fwd", "tile_blend_bwd"))
    for v, out in enumerate(outs):
        for k in ("render", "invdepth", "alpha", "dir"):
            if not bool(torch.isfinite(out[k]).all()):
                fail(f"eval render view {v}: non-finite {k}")
        r = out["render"]
        if not (float(r.min()) >= 0.0 and float(r.max()) <= 1.0):
            fail(f"eval render view {v}: render outside [0, 1]")
        tele = {k: int(out[k]) for k in ("overflow", "tile_peak", "big_peak", "big_overflow")}
        print(f"eval render view {v}: render max {float(r.max()):.4f} alpha max "
              f"{float(out['alpha'].max()):.4f} invdepth max {float(out['invdepth'].max()):.4f} "
              f"|dir| max {float(out['dir'].abs().max()):.4f} telemetry {tele}", flush=True)
    print(f"eval render: {eval_s * 1e3:.3f} ms per eval render (host clock, 4 views, "
          f"first call of the path)", flush=True)
    with torch.no_grad():
        t0 = time.time()
        for cam in cams:
            T.eval_render(ts, cam, pipe_cfg, 0.0)
        torch.cuda.synchronize()
    print(f"eval render: {(time.time() - t0) / len(cams) * 1e3:.3f} ms per eval render "
          f"(host clock, 4 views, repeated)", flush=True)
    if c_eval["tile_blend_fwd"] != len(cams):
        fail(f"the eager eval render of {len(cams)} views launched K3 "
             f"{c_eval['tile_blend_fwd']} times")

    # -- b2. the same views through the graphed eval render, in turns -----------
    k3["launches"] = render_turns("bench", ts, cams, pipe_cfg, smi)

    # -- c. the differentiable full-channel render -----------------------------
    def grad_path():
        g = cs.gaussians(state)
        leaves = [g[k].detach().requires_grad_(True) for k in ("xyz", "scale", "quat", "opacity")]
        out = render(*leaves, cams[0], alive=g["alive"], capacity=pipe_cfg.tile_capacity,
                     big_capacity=pipe_cfg.big_capacity)
        ks = [torch.randn(s, device=dev, generator=gen)
              for s in ((H, W), (H, W), (H, W), (3, H, W))]
        total = ((out["render"] * ks[0]).sum() + (out["invdepth"] * ks[1]).sum()
                 + (out["alpha"] * ks[2]).sum() + (out["dir"] * ks[3]).sum())
        return torch.autograd.grad(total, leaves)

    t0 = time.time()
    grads, c_grad = run_path("full-channel gradient", grad_path,
                             ("tile_blend_fwd", "tile_blend_bwd", "reduce_slots"),
                             ("blend_moment_bwd",))
    print(f"full-channel gradient: {(time.time() - t0) * 1e3:.1f} ms (host clock, one call)",
          flush=True)
    for name, gr in zip(("xyz", "scale", "quat", "opacity"), grads):
        m = float(gr.abs().max())
        print(f"full-channel gradient d {name}: max |.| {m:.4g}", flush=True)
        if not (bool(torch.isfinite(gr).all()) and m > 0):
            fail(f"full-channel gradient d {name} is not finite and nonzero")
    k4["launches"] = c_grad["tile_blend_bwd"]

    # -- d. synthetic ground truth at train.py --synthetic's defaults ------------
    def scene():
        t0 = time.time()
        s = synthetic.make_scene(seed=0, n_curves=8, n_lines=3, n_views=24, height=256,
                                 width=256, device=dev)
        torch.cuda.synchronize()
        return s, time.time() - t0

    (sc, scene_s), _ = run_path("make_scene", scene, ("tile_blend_fwd",))
    for v, m in enumerate(sc.edge_maps):
        if not (bool(torch.isfinite(m).all()) and float(m.min()) >= 0.0
                and float(m.max()) <= 1.0 and float(m.max()) > 0.0):
            fail(f"make_scene view {v}: edge map not finite, in [0, 1] and nonzero")
    print(f"make_scene: 24 views of 256x256 in {scene_s:.3f} s; edge-map max "
          f"{max(float(m.max()) for m in sc.edge_maps):.4f}, mean "
          f"{sum(float(m.mean()) for m in sc.edge_maps) / 24:.5f}", flush=True)

    # -- e. the table and indirect flavors of the training step ------------------
    args = (cams[0], gts[0], 0.0, opt_cfg, pipe_cfg)
    kw = dict(use_mask=False, n_gaussians=M)
    ref = T.step_grads(ts, *args, **kw)[2]
    old = os.environ.get("CGT_BLEND_FLAVOR")
    try:
        for flavor, bwd in (("table", "tile_blend_bwd"), ("indirect", "blend_moment_bwd")):
            os.environ["CGT_BLEND_FLAVOR"] = flavor
            other = "blend_moment_bwd" if bwd == "tile_blend_bwd" else "tile_blend_bwd"
            grads_f, _ = run_path(f"step_grads {flavor}", lambda: T.step_grads(ts, *args, **kw)[2],
                                  ("tile_blend_fwd", bwd, "ssim_fwd", "ssim_bwd"),
                                  ("blend_train_fwd", "blend_train_bwd", other))
            errs = {k: rel_err(grads_f[k], ref[k]) for k in ref}
            print(f"flavor {flavor}: gradient error over max |default| per group "
                  f"{ {k: f'{v:.3g}' for k, v in errs.items()} } (tol {FLAVOR_TOL:g})", flush=True)
            if not max(errs.values()) <= FLAVOR_TOL:
                fail(f"the {flavor} flavor's gradients disagree with the default flavor's")

            def steps(n=6):
                tsf = ts
                for i in range(n):
                    if i == 1:
                        torch.cuda.synchronize()
                        t0 = time.time()
                    tsf, _ = T.train_step(tsf, cams[i % 4], gts[i % 4], 0.0, opt_cfg, pipe_cfg,
                                          **kw)
                torch.cuda.synchronize()
                return (time.time() - t0) / (n - 1)

            step_s, c_f = run_path(f"train_step {flavor}", steps, ("tile_blend_fwd", bwd),
                                   ("blend_train_fwd", "blend_train_bwd"))
            print(f"flavor {flavor}: {step_s * 1e3:.3f} ms/step (host clock, 5 steps after one)",
                  flush=True)
            if flavor == "indirect":
                k5["launches"] = c_f["blend_moment_bwd"]
    finally:
        if old is None:
            os.environ.pop("CGT_BLEND_FLAVOR", None)
        else:
            os.environ["CGT_BLEND_FLAVOR"] = old
    return [k3, k4, k5]


def basis_flavor(inputs, acc_k2, pairs, ts, cams, gts, opt_cfg, pipe_cfg, M):
    """Phase 8 of the module docstring; returns K6b's kernel entry."""
    fields, gidx, counts, col, finT, gc, gtt, _ = inputs
    H, W = col.shape
    acc = launches_bitwise("blend_train_bwd_basis", "main path's K2 inputs",
                           lambda: RC.blend_train_bwd_basis(*inputs))
    acc_p = RC.blend_train_bwd_basis_plain(*inputs[:-1])
    torch.cuda.synchronize()
    d6 = RC.moments_to_dfields(acc, fields)
    e6 = rel_err(d6, RC.moments_to_dfields(acc_p, fields))
    e_k2 = rel_err(d6, RC.moments_to_dfields(acc_k2, fields))
    n_inst, P1, Tn = int(counts.sum()), fields.shape[0], gidx.shape[0]
    b6, by6 = blend_bound(P1 * 32 + n_inst * 4 + Tn * 4 + 4 * H * W * 4 + P1 * 32, pairs,
                          MOMENT_OPS, RECOMB_OPS)
    k6 = dict(
        name="blend_train_bwd_basis", route="cuda", source=BLEND_SRC,
        replaces="curve_gaussian_tpu/ops/rasterize_pallas.py:789", launches=0,
        max_abs_err=(acc - acc_p).abs().max().item(), rel_err=e6,
        ms=cuda_ms(lambda: RC.blend_train_bwd_basis(*inputs), 20),
        plain_ms=cuda_ms(lambda: RC.blend_train_bwd_basis_plain(*inputs[:-1]), 3),
        bound_ms=b6, bound_by=by6, library_ms=None,
    )
    report(k6, f"main path's K2 inputs {pairs_note(pairs)}")
    print(f"kernel blend_train_bwd_basis: {cull_note(pairs, counts, 'K6b')}; its "
          f"recombination once per (instance, tile), {pairs['inst']} with a contributing "
          f"pixel", flush=True)
    k2_ms = cuda_ms(lambda: RC.blend_train_bwd(*inputs), 20)
    print(f"kernel blend_train_bwd_basis against K2: d fields error over max {e_k2:.3g} "
          f"(tol {BASIS_TOL:g}); K2 {k2_ms:.4f} ms in this phase", flush=True)
    if not e_k2 <= BASIS_TOL:
        fail(f"K6b disagrees with K2: {e_k2} > {BASIS_TOL}")

    args = (cams[0], gts[0], 0.0, opt_cfg, pipe_cfg)
    kw = dict(use_mask=False, n_gaussians=M)
    ref = T.step_grads(ts, *args, **kw)[2]
    old = os.environ.get("CGT_BLEND_FLAVOR")
    os.environ["CGT_BLEND_FLAVOR"] = "basis"
    try:
        grads_b, _ = run_path("step_grads basis", lambda: T.step_grads(ts, *args, **kw)[2],
                              ("blend_train_fwd", "blend_train_bwd_basis"),
                              ("blend_train_bwd", "tile_blend_fwd", "tile_blend_bwd",
                               "blend_moment_bwd"))
        errs = {k: rel_err(grads_b[k], ref[k]) for k in ref}
        print(f"flavor basis: gradient error over max |default| per group "
              f"{ {k: f'{v:.3g}' for k, v in errs.items()} } (tol {FLAVOR_TOL:g})", flush=True)
        if not max(errs.values()) <= FLAVOR_TOL:
            fail("the basis flavor's gradients disagree with the default flavor's")

        def steps(n=5):
            tsb = ts
            torch.cuda.synchronize()
            t0 = time.time()
            for i in range(n):
                tsb, _ = T.train_step(tsb, cams[i % 4], gts[i % 4], 0.0, opt_cfg, pipe_cfg, **kw)
            torch.cuda.synchronize()
            return (time.time() - t0) / n

        step_s, c_b = run_path("train_step basis", steps,
                               ("blend_train_fwd", "blend_train_bwd_basis", "ssim_fwd",
                                "ssim_bwd"),
                               ("blend_train_bwd", "tile_blend_fwd", "tile_blend_bwd",
                                "blend_moment_bwd"))
    finally:
        if old is None:
            os.environ.pop("CGT_BLEND_FLAVOR", None)
        else:
            os.environ["CGT_BLEND_FLAVOR"] = old
    if (c_b["blend_train_bwd_basis"], c_b["blend_train_bwd"]) != (5, 0):
        fail(f"5 basis-flavor steps launched K6b {c_b['blend_train_bwd_basis']} times and K2 "
             f"{c_b['blend_train_bwd']} times, not 5 and 0")
    print(f"flavor basis: {step_s * 1e3:.3f} ms/step (host clock, 5 steps)", flush=True)
    k6["launches"] = c_b["blend_train_bwd_basis"]
    return k6


DRIVER_ARGS = ["--synthetic", "--image-size", "512", "--grid-init", "15", "--n-gaussians", "12",
               "--iterations", "600", "--test-iterations", "300", "600",
               "--checkpoint-iterations", "550", "--seed", "0", "--quiet"]
DRIVER_DIR = "output_torch/chip_smoke"


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def driver(dev):
    """Phase 9 of the module docstring."""
    import shutil

    from curve_gaussian_tpu_torch import train as TR
    from curve_gaussian_tpu_torch.engine import checkpoint as CK

    a = TR.parse_args(DRIVER_ARGS)
    n_it, ck_it = a.iterations, a.checkpoint_iterations[0]
    shutil.rmtree(DRIVER_DIR, ignore_errors=True)
    run_dir = os.path.join(DRIVER_DIR, "run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res, c = run_path("driver", lambda: TR.main(DRIVER_ARGS + ["--model-path", run_dir]),
                      ("blend_train_fwd", "blend_train_bwd", "ssim_fwd", "ssim_bwd",
                       "tile_blend_fwd"),
                      ("tile_blend_bwd", "blend_moment_bwd", "blend_train_bwd_basis"))
    main_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    sec = res.seconds
    iters = int(res.ts.step)
    print(f"driver: {iters} iterations in {sec['train']:.2f} s of train_scene, "
          f"{iters / sec['train']:.3f} it/s (host clock); main() {main_s:.2f} s with the scene "
          f"and the eval; peak memory {peak / 2**30:.3f} GiB", flush=True)
    print("driver: host seconds by phase " + ", ".join(
        f"{k} {v:.3f} ({100 * v / sec['train']:.1f}%)" for k, v in sec.items() if k != "train"),
        flush=True)
    fired = set()
    for e in res.events:
        if e["kind"] == "surgery":
            fired.update(e["ops"])
            print(f"driver event {e['iter']}: {'+'.join(e['ops'])} -> {e['curves']} curves "
                  f"(capacity {e['capacity']}), {e['seconds'] * 1e3:.1f} ms host", flush=True)
        else:
            print(f"driver event {e['iter']}: {e['kind']} {e['old']} -> {e['new']} ({e['why']})",
                  flush=True)
    missing = {"densify", "densify_until", "prune_trim", "split", "merge"} - fired
    if missing:
        fail(f"the driver run fired no {sorted(missing)} event")
    # K1, K2, K7, K8 once per step (replayed) and warm-up step; K3 once per view of
    # make_scene, of each test render (replayed) and warm-up render
    check_step_launches("driver run", c, res.graphs, n_it,
                        dict(tile_blend_fwd=a.synthetic_views),
                        renders=(res.render_graphs, 2 * len(a.test_iterations)))
    if iters != n_it:
        fail(f"the driver run ended at step {iters}, not {n_it}")

    for f in ("parametric_edges.json", "metrics.jsonl", "eval.json", f"chkpnt{ck_it}.npz",
              "edge_points.ply", f"point_cloud/iteration_{n_it}/point_cloud.ply",
              *(f"test_images/iter_{i:06d}/v{v:02d}_{k}.png" for i in a.test_iterations
                for v in (0, 1) for k in ("render", "gt", "alpha", "depth", "dir"))):
        if not os.path.exists(os.path.join(run_dir, f)):
            fail(f"the driver run wrote no {f}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    totals = [r["total"] for r in rows if "total" in r]
    tests = [(r["iter"], r["test_l1"], r["test_psnr"]) for r in rows if "test_l1" in r]
    if not (totals and np.isfinite(totals).all()):
        fail("metrics.jsonl holds no finite losses")
    print(f"driver: logged loss first {totals[0]:.5f} last {totals[-1]:.5f}; test (iter, L1, "
          f"PSNR) {tests}", flush=True)
    with open(os.path.join(run_dir, "eval.json")) as fh:
        ev = json.load(fh)
    n_edges = len(res.edge_dict["curves_ctl_pts"]) + len(res.edge_dict["lines_end_pts"])
    print(f"driver eval: {n_edges} edges; chamfer {ev['chamfer']:.5f} " + " ".join(
        f"P/R/F@{t} {ev[f'precision_{t}']:.4f}/{ev[f'recall_{t}']:.4f}/{ev[f'fscore_{t}']:.4f}"
        for t in (0.005, 0.01, 0.02)), flush=True)
    if not np.isfinite(ev["chamfer"]):
        fail("the driver run's Chamfer distance is not finite")

    # a second run from the same seed: the same bits
    again_dir = os.path.join(DRIVER_DIR, "again")
    t0 = time.time()
    again = TR.main(DRIVER_ARGS + ["--model-path", again_dir])
    diff = nonzero(state_differences(res.ts, again.ts))
    files = {f: file_bytes(os.path.join(run_dir, f)) == file_bytes(os.path.join(again_dir, f))
             for f in ("parametric_edges.json", "eval.json")}
    print(f"driver again from the same seed ({time.time() - t0:.2f} s): final state arrays "
          f"that differ {diff} (of {len(T._state_leaves(res.ts))}), files byte-equal {files}",
          flush=True)
    if diff or not all(files.values()):
        fail("two driver runs from one seed differ")

    # the checkpoint, leaf by leaf into a template at its capacity
    ckpt = os.path.join(run_dir, f"chkpnt{ck_it}.npz")
    cap, step = CK.checkpoint_capacity(ckpt)
    template = T.init_train_state(cs.init_state(
        synthetic.grid_seed_points(a.grid_init)[:cap], n_views=a.synthetic_views,
        n_gaussians=a.n_gaussians, capacity=cap, device=dev))
    loaded = CK.load_checkpoint(ckpt, template)
    with np.load(ckpt) as data:
        bad = [k for k, v in CK.named_leaves(loaded).items()
               if not (np.array_equal(CK.leaf_array(v), data[k])
                       and CK.leaf_array(v).dtype == data[k].dtype)]
    print(f"driver checkpoint: step {step}, capacity {cap}, "
          f"{len(CK.named_leaves(loaded))} leaves, bitwise mismatches {bad}", flush=True)
    if step != ck_it or bad:
        fail(f"the checkpoint at {ck_it} does not load back bitwise")

    resume_dir = os.path.join(DRIVER_DIR, "resume")
    t0 = time.time()
    res2, c2 = run_path("driver resume", lambda: TR.main(
        DRIVER_ARGS + ["--model-path", resume_dir, "--start-checkpoint", ckpt]),
        ("blend_train_fwd", "blend_train_bwd"))
    print(f"driver resume: {ck_it} -> {int(res2.ts.step)} in {time.time() - t0:.2f} s, "
          f"{len(res2.edge_dict['curves_ctl_pts'])} curves and "
          f"{len(res2.edge_dict['lines_end_pts'])} lines extracted", flush=True)
    check_step_launches("driver resume", c2, res2.graphs, n_it - ck_it,
                        dict(tile_blend_fwd=a.synthetic_views),
                        renders=(res2.render_graphs,
                                 2 * sum(t > ck_it for t in a.test_iterations)))
    if int(res2.ts.step) != n_it or not os.path.exists(
            os.path.join(resume_dir, "parametric_edges.json")):
        fail(f"the resumed run did not train {ck_it} -> {n_it} and write its "
             "parametric_edges.json")
    return res


VIEWS_PER_STEP = 4


def views_driver(dev, one_view, smi: str):
    """Phase 9b of the module docstring: the driver run of phase 9 (without
    its resume) at ``--views-per-step 4``, beside the one-view run
    `one_view` (its TrainResult)."""
    from curve_gaussian_tpu_torch import train as TR

    a = TR.parse_args(DRIVER_ARGS)
    run_dir = os.path.join(DRIVER_DIR, f"views{VIEWS_PER_STEP}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    res, c = run_path(f"driver views_per_step {VIEWS_PER_STEP}", lambda: TR.main(
        DRIVER_ARGS + ["--model-path", run_dir, "--views-per-step", str(VIEWS_PER_STEP)]),
        TRAIN_KERNELS + ("tile_blend_fwd",),
        ("tile_blend_bwd", "blend_moment_bwd", "blend_train_bwd_basis"))
    peak = torch.cuda.max_memory_allocated()
    check_step_launches(f"driver views_per_step {VIEWS_PER_STEP}", c, res.graphs, a.iterations,
                        dict(tile_blend_fwd=a.synthetic_views), views=VIEWS_PER_STEP,
                        renders=(res.render_graphs, 2 * len(a.test_iterations)))
    if int(res.ts.step) != a.iterations:
        fail(f"the views_per_step {VIEWS_PER_STEP} run ended at step {int(res.ts.step)}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        totals = [json.loads(line).get("total") for line in fh]
    totals = [t for t in totals if t is not None]
    if not (totals and np.isfinite(totals).all()):
        fail(f"the views_per_step {VIEWS_PER_STEP} run logged no finite losses")
    with open(os.path.join(run_dir, "eval.json")) as fh:
        ev = json.load(fh)
    if not np.isfinite(ev["chamfer"]):
        fail(f"the views_per_step {VIEWS_PER_STEP} run's Chamfer distance is not finite")
    for name, r, b in (("one view", one_view, 1), (f"{VIEWS_PER_STEP} views", res,
                                                    VIEWS_PER_STEP)):
        sec, it = r.seconds, int(r.ts.step)
        n = len(r.edge_dict["curves_ctl_pts"]) + len(r.edge_dict["lines_end_pts"])
        print(f"driver at {name} a step: {it} iterations, {it / sec['train']:.3f} it/s, "
              f"{b * it / sec['train']:.3f} views/s (host clock over train_scene); final "
              f"{int(r.ts.alive.sum())} curves, {n} edges extracted; host seconds by phase "
              + ", ".join(f"{k} {v:.3f}" for k, v in sec.items() if k != "train"), flush=True)
    print(f"driver views_per_step {VIEWS_PER_STEP}: logged loss first {totals[0]:.5f} last "
          f"{totals[-1]:.5f}; chamfer {ev['chamfer']:.5f}, F@0.01 {ev['fscore_0.01']:.4f}; "
          f"peak memory {peak / 2**30:.3f} GiB; {smi}", flush=True)


DATASET_DIR = os.path.join(DRIVER_DIR, "refscale")
MAKER_ARGS = ["--out", DATASET_DIR]  # the scene maker's defaults: 1600x1600, 50 views
DATASET_ARGS = ["-r", "2", "--eval", "--iterations", "600", "--test-iterations", "300", "600",
                "--seed", "0", "--quiet"]


def k1_entry(label, fields, b, H, W, pairs=None):
    """K1 against its plain version (bitwise, or fail), timed beside its
    bound; returns (its kernel entry, the pair counts)."""
    gidx, counts = b.gather_idx, b.counts
    bg = torch.zeros(1, device=fields.device)
    col, finT = RC.blend_train_fwd(fields, gidx, counts, bg, H, W)
    col_p, finT_p = RC.blend_train_fwd_plain(fields, gidx, counts, bg, H, W)
    torch.cuda.synchronize()
    n_inst, P1, Tn = int(counts.sum()), fields.shape[0], gidx.shape[0]
    pairs = pair_counts(fields, gidx, counts, H, W) if pairs is None else pairs
    b1, by1 = blend_bound(P1 * 32 + n_inst * 4 + Tn * 4 + 4 + 2 * H * W * 4, pairs, k3_ops(0))
    k = dict(name="blend_train_fwd", route="cuda", source=BLEND_SRC,
             replaces="curve_gaussian_tpu/ops/rasterize_pallas.py:1180", launches=0,
             max_abs_err=max((col - col_p).abs().max().item(), (finT - finT_p).abs().max().item()),
             rel_err=max(rel_err(col, col_p), rel_err(finT, finT_p)),
             ms=cuda_ms(lambda: RC.blend_train_fwd(fields, gidx, counts, bg, H, W), 20),
             plain_ms=cuda_ms(lambda: RC.blend_train_fwd_plain(fields, gidx, counts, bg, H, W), 3),
             bound_ms=b1, bound_by=by1, library_ms=None)
    report(k, label and f"{label} H,W={H},{W} T={Tn} K={gidx.shape[1]} P1={P1} "
                        f"instances={n_inst} peak={int(b.peak)} {pairs_note(pairs)}")
    if not (torch.equal(col, col_p) and torch.equal(finT, finT_p)):
        fail(f"K1 is not equal to its plain version {label or 'on the main path'}")
    return k, pairs


def projection_kernels(state, cam, label):
    """The projection's two kernels against ``preprocess_plain`` on the
    Gaussians of `state` at view `cam` (a training step's, as
    ``step_inputs`` projects them), with seeded cotangents: every forward
    output equal, the four gradients within ``TOL['project_bwd']`` of the
    largest of autograd's through the plain version; each kernel three
    times on the same inputs (bitwise equal); each timed in one CUDA graph
    of 50 launches (``graph_ms``), beside its bound by bytes and the plain
    version in a graph (the backward's: the forward and backward's less
    the forward's); returns their two kernel entries."""
    dev = state.alive.device
    g = cs.gaussians(state)
    ins = [g[k].detach().contiguous() for k in ("xyz", "scale", "quat", "opacity")]
    alive = g["alive"].contiguous()
    P = ins[0].shape[0]
    gen = torch.Generator(dev).manual_seed(0)
    cot = [torch.randn(sh, device=dev, generator=gen) for sh in ((P, 2), (P, 3), (P,), (P,))]
    needs = (True,) * 4

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        with torch.enable_grad():
            pre = fn(*leaves, cam, alive=alive)
            outs = (pre.mean2d, pre.conic, pre.depth, pre.opacity)
            grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)), leaves)
        return PP.Preprocessed(*(t.detach() for t in pre)), grads

    n_fwd, n_bwd = PP.project_fwd.launches, PP.project_bwd.launches
    pre, grads = run(PP.preprocess)
    ref, ref_grads = run(PP.preprocess_plain)
    torch.cuda.synchronize()
    if (PP.project_fwd.launches - n_fwd, PP.project_bwd.launches - n_bwd) != (1, 1):
        fail(f"preprocess on the card launched the projection kernels "
             f"{PP.project_fwd.launches - n_fwd} and {PP.project_bwd.launches - n_bwd} times, "
             f"not once each")
    unequal = {}
    for name in PP.Preprocessed._fields:
        a, r = getattr(pre, name), getattr(ref, name)
        bad = int(((a != r) & ~(a.isnan() & r.isnan()) if a.is_floating_point() else a != r)
                  .sum())
        if bad:
            unequal[name] = bad
    # NaN against NaN counts as equal
    floats = [(getattr(pre, n).nan_to_num(), getattr(ref, n).nan_to_num())
              for n in ("mean2d", "conic", "depth", "opacity", "extent")]

    def flat_fwd():
        return torch.cat([t.reshape(-1).float()
                          for t in PP.project_fwd(*ins, alive, cam, 1.0, False)])

    def flat_bwd():
        return torch.cat([t.reshape(-1)
                          for t in PP.project_bwd(*ins, cam, 1.0, False, cot, needs)])

    where = label or "main path"
    launches_bitwise("project_fwd", where, flat_fwd)
    launches_bitwise("project_bwd", where, flat_bwd)

    def plain_fwd():
        with torch.no_grad():
            PP.preprocess_plain(*ins, cam, alive=alive)

    plain_f = graph_ms(plain_fwd, 3)
    plain_fb = graph_ms(lambda: run(PP.preprocess_plain), 3)
    bf, byf = bound_ms(P * PROJECT_FWD_BYTES, 0)
    bb, byb = bound_ms(P * PROJECT_BWD_BYTES, 0)
    kf = dict(
        name="project_fwd", route="cuda", source=PROJECTION_SRC,
        replaces="curve_gaussian_tpu/ops/projection.py:146", launches=0,
        max_abs_err=max((a - r).abs().max().item() for a, r in floats),
        rel_err=max(rel_err(a, r) for a, r in floats),
        ms=graph_ms(lambda: PP.project_fwd(*ins, alive, cam, 1.0, False), 50),
        plain_ms=plain_f, bound_ms=bf, bound_by=byf, library_ms=None)
    kb = dict(
        name="project_bwd", route="cuda", source=PROJECTION_SRC,
        replaces="curve_gaussian_tpu/ops/projection.py:146", launches=0,
        max_abs_err=max((a - r).abs().max().item() for a, r in zip(grads, ref_grads)),
        rel_err=max(rel_err(a, r) for a, r in zip(grads, ref_grads)),
        ms=graph_ms(lambda: PP.project_bwd(*ins, cam, 1.0, False, cot, needs), 50),
        plain_ms=plain_fb - plain_f, bound_ms=bb, bound_by=byb, library_ms=None)
    print(f"kernel project_fwd {where}: P={P} ({int(alive.sum())} alive, {int(ref.valid.sum())} "
          f"valid), outputs unequal to the plain version's {unequal or 'none'}; plain forward "
          f"{plain_f:.4f} ms, plain forward and backward {plain_fb:.4f} ms (each one CUDA "
          f"graph)", flush=True)
    for k in (kf, kb):
        report(k, label and f"{label} P={P}")
    if unequal:
        fail(f"the projection's forward is not equal to its plain version "
             f"{label or 'on the main path'}: unequal entries {unequal}")
    return [kf, kb]


def binning_kernels(state, cam, label):
    """The binning kernels (``bin_tiles``) against ``bin_gaussians_plain``
    on the Gaussians of `state` at view `cam`, binned as a training step
    bins them (the projection's forward, ``PipelineConfig``'s capacities,
    the slots table): every field of ``Binning`` equal; three launches
    bitwise equal; timed in one CUDA graph of 50 launches (``graph_ms``)
    beside its bound by bytes from this view's pairs and tables and the
    plain version in a graph; returns its kernel entry."""
    pipe = PipelineConfig()
    g = cs.gaussians(state)
    with torch.no_grad():
        pre = PP.preprocess(g["xyz"], g["scale"], g["quat"], g["opacity"], cam, alive=g["alive"])
    H, W = cam.height, cam.width
    kw = dict(capacity=pipe.tile_capacity, big_capacity=pipe.big_capacity, slots=True)
    n0 = BC.bin_tiles.launches
    got = bin_gaussians(pre, H, W, **kw)
    ref = BN.bin_gaussians_plain(pre, H, W, **kw)
    torch.cuda.synchronize()
    if BC.bin_tiles.launches - n0 != 1:
        fail(f"bin_gaussians on the card launched the binning kernels "
             f"{BC.bin_tiles.launches - n0} times, not once")
    diffs = {f: (getattr(got, f).long() - getattr(ref, f).long()).abs()
             for f in BN.Binning._fields}
    unequal = {f: int((d != 0).sum()) for f, d in diffs.items() if bool((d != 0).any())}
    err = max(float(d.max()) if d.numel() else 0.0 for d in diffs.values())
    where = label or "main path"
    launches_bitwise("bin_tiles", where, lambda: torch.cat(
        [t.reshape(-1).long() for t in bin_gaussians(pre, H, W, **kw)]))
    # the candidates: every tile's count below a capacity that drops none
    C = int(BN.bin_gaussians_plain(pre, H, W, capacity=max(int(ref.peak), 1),
                                   big_capacity=pipe.big_capacity).counts.sum())
    P = pre.mean2d.shape[0]
    Tn, K = ref.gather_idx.shape
    R = ref.slots.shape[0]
    b, by = bound_ms(P * BIN_GAUSS_BYTES + C * 16 + Tn * K * 5 + Tn * 4 + R * P * 4, 0)
    k = dict(name="bin_tiles", route="cuda", source=BINNING_SRC,
             replaces="curve_gaussian_tpu/ops/binning.py:333", launches=0, max_abs_err=err,
             rel_err=err, ms=graph_ms(lambda: bin_gaussians(pre, H, W, **kw), 50),
             plain_ms=graph_ms(lambda: BN.bin_gaussians_plain(pre, H, W, **kw), 3), bound_ms=b,
             bound_by=by, library_ms=None)
    print(f"kernel bin_tiles {where}: P={P} ({int(pre.valid.sum())} valid), {C} candidates, "
          f"T={Tn} K={K}, slots [{R}, {P}], big tier {int(ref.big_count)} of "
          f"{pipe.big_capacity}, peak {int(ref.peak)}, overflow {int(ref.overflow)}; fields "
          f"unequal to the plain version's {unequal or 'none'}", flush=True)
    report(k, label and f"{label} P={P}")
    if unequal:
        fail(f"the binning kernels are not equal to the plain version "
             f"{label or 'on the main path'}: unequal entries {unequal}")
    return [k]


def train_kernels(state, cam, inputs, gt, label, library=False):
    """The projection's kernels (``projection_kernels``) and the binning's
    (``binning_kernels``) on the Gaussians of `state` at view `cam`, then
    K1 (bitwise), K2, the slot -> Gaussian reduction (bitwise), K7 and K8
    (bitwise) against their plain versions on that training step's inputs
    (``step_inputs``), K2 and the reduction three times each (bitwise
    equal), timed beside their bounds and the reduction beside
    ``index_add_``; with `library`, K7/K8 beside a cuDNN conv2d SSIM and
    its autograd backward; returns (their eight kernel entries, the pair
    counts, K2's moments)."""
    kproj = projection_kernels(state, cam, label) + binning_kernels(state, cam, label)
    fields, b, col, finT, gc, gtt = inputs
    gidx, counts = b.gather_idx, b.counts
    H, W = col.shape
    dev = col.device
    n_inst, P1, Tn = int(counts.sum()), fields.shape[0], gidx.shape[0]
    pairs = pair_counts(fields, gidx, counts, H, W)
    print(f"blend inputs{label and ' ' + label}: P1={P1} T={Tn} K={gidx.shape[1]} "
          f"instances={n_inst} peak={int(b.peak)} {pairs_note(pairs)}", flush=True)
    print(f"blend inputs{label and ' ' + label}: {cull_note(pairs, counts, 'K1/K2')}",
          flush=True)
    k1, _ = k1_entry(label, fields, b, H, W, pairs)

    where = label or "main path"
    acc = launches_bitwise("blend_train_bwd", where,
                           lambda: RC.blend_train_bwd(fields, gidx, counts, col, finT, gc, gtt,
                                                      b.slots))
    acc_p = RC.blend_train_bwd_plain(fields, gidx, counts, col, finT, gc, gtt)
    torch.cuda.synchronize()
    # the function's bytes (fields, table, counts, four images, the moments
    # out), as K6b's: the slots table is the reduction's input, in its own row
    b2, by2 = blend_bound(P1 * 32 + n_inst * 4 + Tn * 4 + 4 * H * W * 4 + P1 * 32, pairs,
                          MOMENT_OPS)
    k2 = dict(
        name="blend_train_bwd", route="cuda", source=BLEND_SRC,
        replaces="curve_gaussian_tpu/ops/rasterize_pallas.py:1310", launches=0,
        max_abs_err=(acc - acc_p).abs().max().item(),
        rel_err=rel_err(RC.moments_to_dfields(acc, fields), RC.moments_to_dfields(acc_p, fields)),
        ms=cuda_ms(lambda: RC.blend_train_bwd(fields, gidx, counts, col, finT, gc, gtt, b.slots),
                   20),
        plain_ms=cuda_ms(
            lambda: RC.blend_train_bwd_plain(fields, gidx, counts, col, finT, gc, gtt), 3),
        bound_ms=b2, bound_by=by2, library_ms=None)

    # the slot -> Gaussian reduction on K2's slot rows (K2 is those rows reduced)
    rows = RC.moment_rows(fields, gidx, counts, col, finT, gc, gtt)
    red = launches_bitwise("reduce_slots", where, lambda: RC.reduce_slots(rows, b.slots, P1))
    red_p = RC.reduce_slots_plain(rows, b.slots, P1)
    flat = gidx.reshape(-1).long()
    torch.cuda.synchronize()
    R, Pn = b.slots.shape
    br, byr = bound_ms(n_inst * 32 + R * Pn * 4 + P1 * 32, n_inst * 8)
    kr = dict(
        name="reduce_slots", route="cuda", source=BLEND_SRC,
        replaces="curve_gaussian_tpu/ops/rasterize_pallas.py:1988", launches=0,
        max_abs_err=(red - red_p).abs().max().item(), rel_err=rel_err(red, red_p),
        ms=cuda_ms(lambda: RC.reduce_slots(rows, b.slots, P1), 50),
        plain_ms=cuda_ms(lambda: RC.reduce_slots_plain(rows, b.slots, P1), 3),
        bound_ms=br, bound_by=byr,
        library_ms=cuda_ms(lambda: torch.zeros((P1, 8), device=dev).index_add_(
            0, flat, rows.reshape(-1, 8)), 50))
    print(f"kernel reduce_slots {where}: slots table [{R}, {Pn}], {n_inst} listed slot rows; "
          f"K2 equal to its moment rows reduced {torch.equal(acc, red)}", flush=True)
    mom_ms = cuda_ms(lambda: RC.moment_rows(fields, gidx, counts, col, finT, gc, gtt), 20)
    print(f"kernel blend_train_bwd {where}: {k2['ms']:.4f} ms is its whole wrapper (the moment "
          f"kernel, the tickets' memset and the reduction); the moment kernel alone "
          f"{mom_ms:.4f} ms, the reduction alone {kr['ms']:.4f} ms", flush=True)
    if not torch.equal(acc, red):
        fail("K2 is not its slot rows through reduce_slots, bitwise")

    # SSIM on the step's pair: the render against its ground truth
    a = col.contiguous()
    win = torch.tensor(SC.gaussian_window(11), device=dev)
    win2 = (win[:, None] * win[None, :])[None, None]

    def conv_ssim(x, y):
        m = F.conv2d(torch.stack([x, y, x * x, y * y, x * y])[:, None], win2, padding=5)[:, 0]
        mu1, mu2, e11, e22, e12 = m
        return (((2 * mu1 * mu2 + SC.C1) * (2 * (e12 - mu1 * mu2) + SC.C2))
                / ((mu1 * mu1 + mu2 * mu2 + SC.C1) * (e11 - mu1 * mu1 + e22 - mu2 * mu2 + SC.C2))
                ).mean()

    v, v_p = SC.ssim_fwd(a, gt), SC.ssim_fwd_plain(a, gt)
    e7 = abs(v.item() - v_p.item())
    b7, by7 = bound_ms(2 * H * W * 4, H * W * K7_OPS)
    k7 = dict(
        name="ssim_fwd", route="cuda", source="curve_gaussian_tpu_torch/csrc/ssim.cu",
        replaces="curve_gaussian_tpu/ops/ssim_pallas.py:98", launches=0, max_abs_err=e7,
        rel_err=e7, ms=cuda_ms(lambda: SC.ssim_fwd(a, gt), 50),
        plain_ms=cuda_ms(lambda: SC.ssim_fwd_plain(a, gt), 10),
        bound_ms=b7, bound_by=by7,
        library_ms=cuda_ms(lambda: conv_ssim(a, gt), 50) if library else None)
    gbar = torch.full((), -0.1, device=dev)
    d1, d2 = SC.ssim_bwd(a, gt, gbar)
    d1p, d2p = SC.ssim_bwd_plain(a, gt, gbar)
    torch.cuda.synchronize()
    b8, by8 = bound_ms(4 * H * W * 4, H * W * K8_OPS)
    ag = a.clone().requires_grad_(True)
    bgr = gt.clone().requires_grad_(True)

    def conv_ssim_value():
        with torch.enable_grad():
            return conv_ssim(ag, bgr)

    k8 = dict(
        name="ssim_bwd", route="cuda", source="curve_gaussian_tpu_torch/csrc/ssim.cu",
        replaces="curve_gaussian_tpu/ops/ssim_pallas.py:128", launches=0,
        max_abs_err=max((d1 - d1p).abs().max().item(), (d2 - d2p).abs().max().item()),
        rel_err=max(rel_err(d1, d1p), rel_err(d2, d2p)),
        ms=cuda_ms(lambda: SC.ssim_bwd(a, gt, gbar), 50),
        plain_ms=cuda_ms(lambda: SC.ssim_bwd_plain(a, gt, gbar), 10),
        bound_ms=b8, bound_by=by8,
        library_ms=cuda_ms(lambda v: torch.autograd.grad(v, (ag, bgr)), 50,
                           setup=conv_ssim_value) if library else None)
    shape = label and f"{label} H,W={H},{W}"
    for k in (k2, kr, k7, k8):
        report(k, shape)
    if not (torch.equal(d1, d1p) and torch.equal(d2, d2p)):
        fail(f"K8 is not equal to its plain version {label or 'on the main path'}'s pair")
    return kproj + [k1, k2, kr, k7, k8], pairs, acc


def dataset_scene(dev, smi: str, profile=False):
    """Phase 10 of the module docstring; with `profile`, a torch.profiler
    table of two steps of the loaded scene."""
    import shutil

    from curve_gaussian_tpu_torch import train as TR
    from curve_gaussian_tpu_torch.config import ModelConfig
    from curve_gaussian_tpu_torch.data import dataset as DS
    from curve_gaussian_tpu_torch.data.png import read_png, resize_bicubic_u8
    from curve_gaussian_tpu_torch.scripts import make_ref_scale_scene as MK

    # -- a. the scene ------------------------------------------------------------
    shutil.rmtree(DATASET_DIR, ignore_errors=True)
    mk_args = MK.parse_args(MAKER_ARGS)
    t0 = time.time()
    made, c = run_path("make_ref_scale_scene",
                       lambda: MK.make_ref_scale_scene(MAKER_ARGS, quiet=True),
                       ("blend_train_fwd",), ("blend_train_bwd", "tile_blend_fwd"))
    sec = made["seconds"]
    print(f"dataset scene: {mk_args.views} views of {mk_args.size}x{mk_args.size} in "
          f"{time.time() - t0:.2f} s: render {sec['render']:.2f} s, write {sec['write']:.2f} s "
          f"(host clock); overflow per view {made['overflow']}", flush=True)
    if c["blend_train_fwd"] != mk_args.views or any(made["overflow"]):
        fail(f"the scene maker launched K1 {c['blend_train_fwd']} times, not {mk_args.views}, "
             f"or a view overflowed")

    # -- b. load at -r 2 ------------------------------------------------------------
    view0 = os.path.join(DATASET_DIR, "edge_DexiNed", "0000.png")
    t0 = time.time()
    scene = DS.load_scene(ModelConfig(source_path=DATASET_DIR, resolution=2), device=dev)
    load_s = time.time() - t0
    t0 = time.time()
    u8 = read_png(view0)
    read_s = time.time() - t0
    paeth = os.path.join(DRIVER_DIR, "view0_paeth.png")
    write_png_paeth(paeth, u8)
    t0 = time.time()
    u8_paeth = read_png(paeth)
    paeth_s = time.time() - t0
    t0 = time.time()
    resize_bicubic_u8(u8, mk_args.size // 2, mk_args.size // 2)
    resize_s = time.time() - t0
    cam0 = scene.train_cameras[0]
    H, W = cam0.height, cam0.width
    print(f"dataset load: {len(scene.train_cameras)} views at {H}x{W} in {load_s:.2f} s "
          f"(host clock; one view: read_png {read_s * 1e3:.1f} ms as written (filter 0, the "
          f"row path), {paeth_s * 1e3:.1f} ms with Paeth on every row (the diagonal sweep), "
          f"resize {resize_s * 1e3:.1f} ms); {len(scene.seed_points)} seed points, extent "
          f"{scene.cameras_extent:.4f}", flush=True)
    if not (np.array_equal(u8, made["first_view"]) and np.array_equal(u8_paeth, u8)):
        fail("read_png of view 0, as written or with Paeth rows, differs from the array the "
             "scene maker wrote")
    if (H, W) != (mk_args.size // 2, mk_args.size // 2):
        fail(f"the scene loaded at -r 2 is {H}x{W}")

    # -- c. the kernels at the new shapes --------------------------------------------
    pipe_cfg = PipelineConfig()
    state = cs.init_state(scene.seed_points, n_views=len(scene.train_cameras), n_gaussians=12,
                          device=dev)
    gt = torch.as_tensor(scene.train_edge_maps[0], device=dev)
    inputs = step_inputs(state, cam0, gt, pipe_cfg, slots=True)
    train_kernels(state, cam0, inputs, gt, "dataset step")
    ssim_checks(inputs[2], gt)
    fields3, b3 = tile_inputs(state, cam0, pipe_cfg, True, True, True)
    k3_entry("dataset eval render", fields3, b3, H, W, True, True, True)
    del fields3, b3

    # K1 on the scene maker's splats at full size, view 0
    _, _, splats = MK.scene_splats(mk_args, dev)
    cam_full = synthetic.ring_cameras(mk_args.views, mk_args.size, mk_args.size, device=dev)[0]
    with torch.no_grad():
        pre = PP.preprocess(*splats, cam_full)
        bf = bin_gaussians(pre, mk_args.size, mk_args.size, capacity=mk_args.tile_capacity,
                           big_capacity=1024)
        ff = RC.stack_fields(pre).contiguous()
    k1_entry("scene maker view 0", ff, bf, mk_args.size, mk_args.size)
    del inputs, ff, bf, pre
    if profile:
        ts = T.init_train_state(state)
        gts = [torch.as_tensor(m, device=dev) for m in scene.train_edge_maps[:4]]
        opt_cfg = OptimizationConfig()

        def step(i):
            nonlocal ts
            ts, _ = T.train_step(ts, scene.train_cameras[i % 4], gts[i % 4], 0.0, opt_cfg,
                                 pipe_cfg, use_mask=False, n_gaussians=12)

        for i in range(3):
            step(i)
        profile_step(lambda: [step(i) for i in range(2)], 2, "eager dataset step")
        del ts, gts

    # -- d. train it through the CLI ----------------------------------------------------
    run_dir = os.path.join(DRIVER_DIR, "refscale_run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res, c = run_path("dataset driver",
                      lambda: TR.main(["-s", DATASET_DIR, "--model-path", run_dir] + DATASET_ARGS),
                      ("blend_train_fwd", "blend_train_bwd", "ssim_fwd", "ssim_bwd",
                       "tile_blend_fwd"),
                      ("tile_blend_bwd", "blend_moment_bwd", "blend_train_bwd_basis"))
    main_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    a = TR.parse_args(DATASET_ARGS)
    sec = res.seconds
    iters = int(res.ts.step)
    print(f"dataset driver: {iters} iterations in {sec['train']:.2f} s of train_scene, "
          f"{iters / sec['train']:.3f} it/s (host clock); main() {main_s:.2f} s with the load "
          f"and the eval; peak memory {peak / 2**30:.3f} GiB", flush=True)
    print("dataset driver: host seconds by phase " + ", ".join(
        f"{k} {v:.3f} ({100 * v / sec['train']:.1f}%)" for k, v in sec.items() if k != "train"),
        flush=True)
    for e in res.events:
        if e["kind"] == "surgery":
            print(f"dataset driver event {e['iter']}: {'+'.join(e['ops'])} -> {e['curves']} "
                  f"curves (capacity {e['capacity']}), {e['seconds'] * 1e3:.1f} ms host",
                  flush=True)
        else:
            print(f"dataset driver event {e['iter']}: {e['kind']} {e['old']} -> {e['new']} "
                  f"({e['why']})", flush=True)
    # under --eval every view of an EMAP scene is a test view too
    check_step_launches("dataset run", c, res.graphs, a.iterations, {},
                        renders=(res.render_graphs,
                                 len(scene.train_cameras) * len(a.test_iterations)))
    if iters != a.iterations or res.ts.params["curve_points"].device.type != "cuda":
        fail(f"the dataset run ended at step {iters} or left the card")
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    totals = [r["total"] for r in rows if "total" in r]
    tests = [(r["iter"], r["test_l1"], r["test_psnr"]) for r in rows if "test_l1" in r]
    with open(os.path.join(run_dir, "eval.json")) as fh:
        ev = json.load(fh)
    n_edges = len(res.edge_dict["curves_ctl_pts"]) + len(res.edge_dict["lines_end_pts"])
    print(f"dataset driver: logged loss first {totals[0]:.5f} last {totals[-1]:.5f}; test "
          f"(iter, L1, PSNR) {tests}", flush=True)
    print(f"dataset eval: {n_edges} edges; chamfer {ev['chamfer']:.5f} " + " ".join(
        f"P/R/F@{t} {ev[f'precision_{t}']:.4f}/{ev[f'recall_{t}']:.4f}/{ev[f'fscore_{t}']:.4f}"
        for t in (0.005, 0.01, 0.02)), flush=True)
    if not (totals and np.isfinite(totals).all() and len(tests) == len(a.test_iterations)
            and np.isfinite(np.array(tests, float)).all()
            and all(np.isfinite(v) for v in ev.values())):
        fail("the dataset run logged a non-finite loss, test metric or eval.json value")

    # -- e. its test views through the graphed eval render, at 800x800 -----------------
    render_turns("dataset", res.ts, scene.train_cameras, res.pipe_cfg, smi)
    return scene


CURVES_DIR = os.path.join(DRIVER_DIR, "render_curves")
BATCH_DIR = os.path.join(DRIVER_DIR, "abc")
BATCH_EXTRA = ["--iterations", "300", "--seed", "0", "--quiet"]
REPLICA_VIEWS = 5


def write_abc_gt(gt_dir: str, edges: dict, scans) -> None:
    """An ABC-format GT directory of the curves in `edges` (the extraction
    format) for each scan: every edge a vertex chain in obj/<scan>_gt.obj
    (a Bézier sampled at 64 parameters, a line its two endpoints), typed
    BSpline or Line and sharp, with the bbox [0,0,0,1,1,1,1,1,1], so that
    the harness's unit-cube normalisation is the identity."""
    from curve_gaussian_tpu_torch.models.fitting import sample_bezier

    verts, feats = [], []
    for kind, chains in (
            ("BSpline", [sample_bezier(cp, np.linspace(0.0, 1.0, 64)) for cp in
                         np.asarray(edges["curves_ctl_pts"], float).reshape(-1, 4, 3)]),
            ("Line", list(np.asarray(edges["lines_end_pts"], float).reshape(-1, 2, 3)))):
        for chain in chains:
            feats.append({"type": kind, "sharp": True,
                          "vert_indices": list(range(len(verts), len(verts) + len(chain)))})
            verts.extend(chain)
    os.makedirs(os.path.join(gt_dir, "obj"))
    for scan in scans:
        with open(os.path.join(gt_dir, "obj", f"{scan}_gt.obj"), "w") as f:
            f.writelines(f"v {float(x)!r} {float(y)!r} {float(z)!r}\n" for x, y, z in verts)
    with open(os.path.join(gt_dir, "chunk_0000_feats.json"), "w") as f:
        json.dump({scan: feats for scan in scans}, f)
    with open(os.path.join(gt_dir, "chunk_0000_stats.json"), "w") as f:
        json.dump({scan: {"bbox": [0, 0, 0, 1, 1, 1, 1, 1, 1]} for scan in scans}, f)


def eval_export(dev, ts, cams, gts, pipe_cfg, scene):
    """Phase 11 of the module docstring; returns K3's entry on the inputs of
    render_curves' frame 0, with the launches of its run."""
    import hashlib
    import shutil

    from curve_gaussian_tpu_torch import train as TR
    from curve_gaussian_tpu_torch.eval import replica as RP
    from curve_gaussian_tpu_torch.ops.ssim import ssim as ssim_any
    from curve_gaussian_tpu_torch.scripts import render_curves as RV
    from curve_gaussian_tpu_torch.scripts import run_batch_abc as RB

    # -- a. render_curves of the driver's curves ----------------------------------------
    edges = os.path.join(DRIVER_DIR, "run", "parametric_edges.json")
    shutil.rmtree(CURVES_DIR, ignore_errors=True)
    # the defaults: 60 orbit frames of 512x512
    argv = ["--edges", edges, "--out", CURVES_DIR, "--device", str(dev)]
    a = RV.parse_args(argv)
    t0 = time.time()
    res, c = run_path("render_curves", lambda: RV.render_curves(argv, quiet=True),
                      RENDER_KERNELS, tuple(n for n in WRAPPERS if n not in RENDER_KERNELS))
    wall = time.time() - t0
    n = len(res["sha256"])
    warm = check_render_graphs("render_curves", res["graphs"], n)
    k3_dev = device_launches(c, res["graphs"])["tile_blend_fwd"]
    if n != a.n_orbit or k3_dev != n + warm:
        fail(f"render_curves wrote {n} frames and launched K3 {k3_dev} times on the device, "
             f"not {a.n_orbit} and one per frame and warm-up render")
    for i in range(n):
        u8 = PNG.read_png(os.path.join(res["frame_dir"], f"frame_{i:04d}.png"))
        if u8.shape != (a.size, a.size) or hashlib.sha256(u8.tobytes()).hexdigest() != \
                res["sha256"][i]:
            fail(f"render_curves frame {i} does not read back as the array written")
    with open(edges) as f:
        edge_dict = json.load(f)
    splats = RV.edge_gaussians(edge_dict, a.width, dev)
    vcams = RV.video_cameras(a, dev)
    fields, b = splat_inputs(*splats, vcams[0], RV.CAPACITY, 1024, True, True, True)
    k3, outs, _ = k3_entry("render_curves frame 0", fields, b, a.size, a.size, True, True, True)
    k3["launches"] = k3_dev
    if not np.array_equal(outs[0].clamp(0.0, 1.0).cpu().numpy(), res["first_frame"]):
        fail("render_curves' frame 0 is not K3's render of its inputs")
    # the graphed frames against an eager render of the first and last cameras
    gauss = dict(zip(("xyz", "scale", "quat", "opacity"), splats))
    for i in (0, n - 1):
        with torch.no_grad():
            img = RV.frame_render(gauss, vcams[i]).cpu().numpy()
        if hashlib.sha256(RV.frame_u8(img).tobytes()).hexdigest() != res["sha256"][i]:
            fail(f"render_curves frame {i} (replayed) differs from an eager render of its camera")
    print(f"render_curves: frames 0 and {n - 1} replayed bitwise as eager renders (SHA-256)",
          flush=True)
    rs, ws = np.array(res["render_seconds"]) * 1e3, np.array(res["write_seconds"]) * 1e3
    print(f"render_curves: {n} frames of {a.size}x{a.size}, {len(edge_dict['curves_ctl_pts'])} "
          f"curves and {len(edge_dict['lines_end_pts'])} lines as {splats[0].shape[0]} "
          f"Gaussians, {wall:.2f} s; host ms per frame: render median {np.median(rs):.3f} "
          f"(mean {rs.mean():.3f}, min {rs.min():.3f}, max {rs.max():.3f}), write median "
          f"{np.median(ws):.3f}; K3 {k3['ms']:.4f} ms; video {res['video']}", flush=True)

    # -- b. batched SSIM on the bench views' renders -------------------------------------
    with torch.no_grad():
        renders = torch.stack([T.eval_render(ts, cam, pipe_cfg, 0.0)["render"] for cam in cams])
    gt_stack = torch.stack(gts)
    pairs = [float(SC.ssim_fwd(renders[i].contiguous(), gts[i])) for i in range(len(gts))]
    x = renders.clone().requires_grad_(True)
    with torch.enable_grad():
        v = ssim_any(x, gt_stack)
        v.backward()
    v = float(v.detach())
    err = abs(v - float(np.mean(pairs)))
    ms = cuda_ms(lambda: ssim_any(renders, gt_stack), 10)
    print(f"batched ssim {tuple(renders.shape)}: {v:.7f} against K7's per-pair mean "
          f"{float(np.mean(pairs)):.7f} (|difference| {err:.3g}, tol 1e-5); {ms:.4f} ms "
          f"forward; gradient max |{float(x.grad.abs().max()):.3g}|", flush=True)
    if not (err <= 1e-5 and bool(torch.isfinite(x.grad).all())):
        fail("the batched SSIM disagrees with K7's per-pair mean or has a non-finite gradient")

    # -- c. the ABC harness and the batch driver -----------------------------------------
    shutil.rmtree(BATCH_DIR, ignore_errors=True)
    gt_dir, data, out = (os.path.join(BATCH_DIR, d) for d in ("gt", "scans", "out"))
    done_scan, new_scan = "00000001", "00000002"
    with open(os.path.join(DATASET_DIR, "gt_edges.json")) as f:
        write_abc_gt(gt_dir, json.load(f), (done_scan, new_scan))
    os.makedirs(data)
    for scan in (done_scan, new_scan):
        os.symlink(os.path.abspath(DATASET_DIR), os.path.join(data, scan))
    shutil.copytree(os.path.join(DRIVER_DIR, "refscale_run"), os.path.join(out, done_scan))
    batch = ["--data-root", data, "--output-root", out, "--gt-base-dir", gt_dir, "--in-process",
             "--device", str(dev), "--extra"] + BATCH_EXTRA
    trained, real_main = [], TR.main

    def main_timed(argv):  # the scan's TrainResult and host seconds
        t1 = time.time()
        r = real_main(argv)
        trained.append((r, time.time() - t1))
        return r

    TR.main = main_timed
    try:
        t0 = time.time()
        (done, skipped, failed), c = run_path("batch driver", lambda: RB.main(batch),
                                              TRAIN_KERNELS)
        wall = time.time() - t0
    finally:
        TR.main = real_main
    if (done, skipped, failed) != ([new_scan], [done_scan], []) or len(trained) != 1:
        fail(f"the batch driver trained {done}, skipped {skipped}, failed {failed}")
    r, train_s = trained[0]
    iters = int(r.ts.step)
    check_step_launches("batch scan", c, r.graphs, iters, dict(tile_blend_fwd=0))
    with open(os.path.join(out, "eval_summary.json")) as f:
        summary = json.load(f)
    mean = summary["mean"]
    print(f"batch driver: scan {new_scan} {iters} iterations, {iters / r.seconds['train']:.3f} "
          f"it/s over train_scene, main() {train_s:.2f} s; the rest of the batch (skip, eval "
          f"of 2 scans, diagnostics) {wall - train_s:.2f} s", flush=True)
    print("batch eval mean: " + ", ".join(f"{k} {mean[k]}" for k in sorted(mean)), flush=True)
    per_type = {f"{m}_{t}" for m in ("acc", "comp") for t in ("curve", "line")}
    if not (sorted(summary["per_scan"]) == [done_scan, new_scan] and per_type <= set(mean)
            and all(np.isfinite(v) for s in summary["per_scan"].values() for v in s.values())
            and all(np.isfinite(v) for v in mean.values())):
        fail("eval_summary.json lacks a scan or a per-type metric, or holds a non-finite one")
    if RB.main(batch) != ([], [done_scan, new_scan], []):
        fail("a second batch run did not skip both scans")

    # -- d. Replica overlays of the dataset run's curves ------------------------------------
    rep_dir = os.path.join(DRIVER_DIR, "replica")
    shutil.rmtree(rep_dir, ignore_errors=True)
    pred = os.path.join(DRIVER_DIR, "refscale_run", "parametric_edges.json")
    t0 = time.time()
    stats = RP.evaluate_replica(pred, scene.train_cameras[:REPLICA_VIEWS],
                                scene.train_edge_maps[:REPLICA_VIEWS], rep_dir)
    rep_s = time.time() - t0
    with open(pred) as f:
        ed = json.load(f)
    with open(os.path.join(rep_dir, "stats.json")) as f:
        on_disk = json.load(f)
    want = {"n_curves": len(ed["curves_ctl_pts"]), "n_lines": len(ed["lines_end_pts"]),
            "n_frames": REPLICA_VIEWS}
    cam0 = scene.train_cameras[0]
    shapes = {PNG.read_png(os.path.join(rep_dir, f"frame_{i:04d}.png")).shape
              for i in range(REPLICA_VIEWS)}
    print(f"replica overlays: {stats} in {rep_s:.2f} s, frame shapes {shapes}", flush=True)
    if stats != want or on_disk != want or shapes != {(cam0.height, 2 * cam0.width, 3)}:
        fail(f"replica stats {stats} (on disk {on_disk}) are not {want}, or a frame is not "
             f"[H, 2W, 3]")
    return k3


def write_png_paeth(path: str, img: np.ndarray) -> None:
    """An 8-bit greyscale [H, W] uint8 image as a PNG with the Paeth filter
    (4) on every row, the filter libpng's adaptive choice often takes."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x - pred) & 0xFF).astype(np.uint8)
    h, w = img.shape
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(PNG.SIGNATURE)
        f.write(PNG._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(PNG._chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(PNG._chunk(b"IEND", b""))


class _Writes:
    """The files a process opens for writing under `root` while ``on``
    (the interpreter's audit events)."""

    def __init__(self, root: str):
        self.root, self.paths, self.on = os.path.abspath(root), [], False
        sys.addaudithook(self)

    def __call__(self, event, args):
        if self.on and event == "open" and isinstance(args[1], str) and any(
                c in args[1] for c in "wax+") and isinstance(args[0], str):
            path = os.path.abspath(args[0])
            if path.startswith(self.root):
                self.paths.append(os.path.relpath(path, self.root))


def replicated(ts, what: str) -> None:
    """Fails unless every rank holds `ts` bit for bit."""
    from curve_gaussian_tpu_torch.parallel import dryrun as DRY

    if not DRY.replicated(ts):
        fail(f"the ranks' states differ {what}")


CARDS_DIR = os.path.join(DRIVER_DIR, "cards")
# every rank's whole phase; under any call limit that holds two such phases
# (--cards 2 then --cards 4), so a phase that runs out still prints its ranks
CARDS_TIMEOUT_S = 420
# a rank still running this many seconds before the deadline prints the
# Python stack of each of its threads, so a hang names where it waits
CARDS_STACKS_BEFORE_S = 20
CARDS_VIEWS = 4  # views a step, CARDS_VIEWS / N a rank
CARDS_STEPS = 20


def cards_main(n: int) -> None:
    """``--cards N``: phase 13 alone (the module docstring).  Starts the N
    ranks (this script with ``--cards N --rank R``), then holds K1, K2, K3,
    K7 and K8 against their plain versions on cuda:0 at the shapes the
    ranks gave them; the kernel line carries each rank's launches."""
    import shutil

    from curve_gaussian_tpu_torch.scripts import render_curves as RV

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if n < 2 or CARDS_VIEWS % n:
        fail(f"--cards takes 2 or 4 (a divisor of {CARDS_VIEWS} views a step), not {n}")
    have = torch.cuda.device_count()
    if have < n:
        fail(f"--cards {n} needs {n} CUDA cards; this machine has {have}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smis = smi_lines()
    for i, line in enumerate(smis):
        print(f"card {i}: {line}", flush=True)
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
            said = f"exit {out.returncode}):\n{(out.stdout + out.stderr).rstrip()}"
        except subprocess.TimeoutExpired:
            said = "no answer in 60 s)"
        print(f"{' '.join(cmd)} ({said}", flush=True)
    print("peer access (row can read column): " + "; ".join(
        f"{i}: " + "".join("-" if i == j else "x" if torch.cuda.can_device_access_peer(i, j)
                           else "." for j in range(have)) for i in range(have)), flush=True)
    nvcc_v = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc_v.stdout.strip().splitlines()[-1]} nccl {MH.nccl_version()}", flush=True)
    t0 = time.time()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.time() - t0:.1f} s", flush=True)

    shutil.rmtree(CARDS_DIR, ignore_errors=True)
    os.makedirs(CARDS_DIR)
    env = dict(os.environ, CGT_NUM_PROCESSES=str(n),
               CGT_COORDINATOR="file://" + os.path.abspath(os.path.join(CARDS_DIR, "rendezvous")))
    t0 = time.time()
    res = MH.run_ranks([[sys.executable, os.path.abspath(__file__), "--cards", str(n), "--rank",
                         str(r)] for r in range(n)], CARDS_TIMEOUT_S, env=env)
    for r in res:
        print(f"rank {r.rank}: {'timed out' if r.timed_out else f'exit {r.returncode}'} after "
              f"{r.seconds:.1f} s (limit {CARDS_TIMEOUT_S} s)", flush=True)
        for line in r.output.splitlines():
            print(f"[rank {r.rank}] {line}", flush=True)
    bad = MH.failures(res)
    if bad:
        fail(f"{n} ranks over NCCL, one card each:\n{bad}")
    print(f"{n} cards: phase {time.time() - t0:.1f} s (host clock, the ranks' start "
          f"included); {smis[0]}", flush=True)
    ranks = []
    for r in range(n):
        with open(os.path.join(CARDS_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    # -- the kernels of the path against their plain versions, on cuda:0 ---------------
    dev = torch.device("cuda", 0)
    H = W = 512
    cams = synthetic.ring_cameras(CARDS_VIEWS, H, W, device=dev)
    rng = np.random.default_rng(0)
    gts = [torch.tensor(rng.uniform(size=(H, W)) ** 4, dtype=torch.float32, device=dev)
           for _ in range(CARDS_VIEWS)]
    state = cs.init_state(synthetic.grid_seed_points(15), n_views=CARDS_VIEWS, n_gaussians=12,
                          device=dev)
    kernels, _, _ = train_kernels(state, cams[0],
                                  step_inputs(state, cams[0], gts[0], PipelineConfig(),
                                              slots=True), gts[0],
                                  "", library=True)
    a = RV.parse_args(["--edges", "unused", "--device", "cuda:0"])
    with open(os.path.join(CARDS_DIR, "driver", "parametric_edges.json")) as f:
        splats = RV.edge_gaussians(json.load(f), a.width, dev)
    gauss = dict(zip(("xyz", "scale", "quat", "opacity"), splats))
    with torch.no_grad():
        fields, b, rows, _ = PS._band_inputs(gauss, RV.video_cameras(a, dev)[0],
                                             PipelineConfig(tile_capacity=RV.CAPACITY), n, 0)
    k3, _, _ = k3_entry(f"render_curves frame 0, rank 0's band of {n}", fields.contiguous(), b,
                        rows, a.size, True, True, True)
    kernels.append(k3)
    for k in kernels:
        by_rank = [r["launches"][k["name"]] for r in ranks]
        k["launches"], k["launches_by_rank"] = by_rank[0], by_rank
    print(json.dumps({"kernels": [{k: v for k, v in d.items() if k != "rel_err"}
                                  for d in kernels]}), flush=True)
    print(smis[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def state_within(label: str, got, refs: dict, e1, e2, tol: float) -> None:
    """Fails unless every state array of `got` lies within
    ``RANKS_STATE_SLACK`` x max |e2 - e1| + `tol` x max |e1| of the same
    array of each state in `refs` ({name: TrainState}): e1 and e2 are two
    runs of one step from one state (NCCL's sum order over N cards is not
    fixed); prints the worst arrays."""
    gl = T._state_leaves(got)
    l1, l2 = T._state_leaves(e1), T._state_leaves(e2)
    worst = []
    for k, e in l1.items():
        e = e.double()
        bound = RANKS_STATE_SLACK * (l2[k].double() - e).abs().max().item() + \
            tol * e.abs().max().item()
        for name, ref in refs.items():
            d = (gl[k].double() - T._state_leaves(ref)[k].double()).abs().max().item()
            worst.append((d / bound if bound > 0 else (0.0 if d == 0 else np.inf), name, k, d,
                          bound))
    worst.sort(key=lambda w: -w[0])
    print(f"{label}, state, worst (max |difference| over its bound): " + ", ".join(
        f"{n} {k} {d:.3g}/{b:.3g}" for _, n, k, d, b in worst[:6]), flush=True)
    if worst[0][0] > 1.0:
        fail(f"{label}: {worst[0][2]} is further from the {worst[0][1]} step than "
             f"{RANKS_STATE_SLACK:g} x a second step's distance plus {tol:g} of max")


def cards_rank_main(n: int, rank: int) -> None:
    """One rank of phase 13 on cuda:`rank`: the group from the environment
    ``cards_main`` sets, over NCCL."""
    import torch.distributed as dist

    from curve_gaussian_tpu_torch import train as TR
    from curve_gaussian_tpu_torch.engine import loop as LOOP
    from curve_gaussian_tpu_torch.parallel import dryrun as DRY
    from curve_gaussian_tpu_torch.scripts import render_curves as RV

    import faulthandler

    t_start = time.time()
    faulthandler.dump_traceback_later(CARDS_TIMEOUT_S - CARDS_STACKS_BEFORE_S)
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    MH.initialize_distributed(process_id=rank, device=dev)
    mesh = PS.make_mesh(n, device=dev)
    if torch.cuda.current_device() != rank or dist.get_backend() != "nccl":
        fail(f"rank {rank}: current device {torch.cuda.current_device()}, backend "
             f"{dist.get_backend()}")
    writes = _Writes(CARDS_DIR)
    per = CARDS_VIEWS // n
    print(f"rank {rank} of {mesh.size} on {dev} ({torch.cuda.get_device_name(dev)}), NCCL "
          f"{MH.nccl_version()}, {per} of {CARDS_VIEWS} views a step", flush=True)

    # -- the bench configuration, as the main path's ---------------------------------
    H = W = 512
    n_views, M = CARDS_VIEWS, 12
    cams = synthetic.ring_cameras(n_views, H, W, device=dev)
    rng = np.random.default_rng(0)
    gts = [torch.tensor(rng.uniform(size=(H, W)) ** 4, dtype=torch.float32, device=dev)
           for _ in range(n_views)]
    state = cs.init_state(synthetic.grid_seed_points(15), n_views=n_views, n_gaussians=M,
                          device=dev)
    ts = T.init_train_state(state)
    opt_cfg, pipe_cfg = OptimizationConfig(), PipelineConfig()
    stacks = T.camera_stacks(cams, torch.float32, dev)
    gt_stack = torch.stack(gts)
    geom = (H, W, cams[0].tanfovx, cams[0].tanfovy)
    views = list(range(CARDS_VIEWS))
    graphs = T.StepGraphs(PS.batch_step(n))
    if not graphs.fuses():
        fail("the multi-rank step graphs hold no collectives")
    counts = {k: 0 for k in WRAPPERS}
    steps_run = [0]

    def run(table):
        """One chunk from `ts`; (state, metrics, host seconds to the end of
        its device work); the ranks' states bitwise equal."""
        before = {k: w.launches for k, w in WRAPPERS.items()}
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.time()
        out = PS.parallel_train_steps_scan(ts, stacks, gt_stack, 0.0, opt_cfg, pipe_cfg,
                                           use_mask=False, mesh_shape=mesh.shape, cam_geom=geom,
                                           rows=[mesh.block(r) for r in table], graphs=graphs)
        torch.cuda.synchronize()
        dt = time.time() - t0
        for k, w in WRAPPERS.items():
            counts[k] += w.launches - before[k]
        steps_run[0] += len(table)
        replicated(out[0], f"after a chunk of {len(table)} steps")
        return out[0], out[1], dt

    # -- a. one fused step -------------------------------------------------------------------
    f1, mf1, _ = run([views])
    lf = float(mf1["total"][0])

    # -- c. what the fused graph holds ------------------------------------------------------
    fcap = graphs.captures[0]
    nodes = graph_nodes(graphs.latest_graph())
    print(f"fused step graph: nodes {nodes}, NCCL kernels {fcap['nccl_kernels']} (capture "
          f"{fcap['seconds']:.3f} s: warm-up {fcap['warmup_seconds']:.3f}, capture "
          f"{fcap['capture_seconds']:.3f}, instantiation {fcap['instantiate_seconds']:.3f})",
          flush=True)
    if nodes.get("host", 0) or nodes.get("memcpy_from_host", 0) or fcap["nccl_kernels"] < 1:
        fail(f"the fused step graph holds host work or no NCCL kernel: {nodes}, "
             f"{fcap['nccl_kernels']} NCCL kernels")
    # the SUM buffer (live gradients, the screen-space gradient, the loss, the
    # visibility, the two overflows, the views) and the MAX one (radii, tile peak)
    P = ts.max_radii.shape[0]
    live = sum(v.numel() for k, v in ts.params.items() if k not in T.dead_groups(False))
    probe = (torch.zeros(live + 3 * P + 4, device=dev), torch.zeros(P + 1, device=dev))
    nbytes = sum(b.numel() * b.element_size() for b in probe)
    print(f"one step exchanges {nbytes} bytes a rank: SUM of {probe[0].numel()} and MAX of "
          f"{probe[1].numel()} float32", flush=True)
    if graphs.exchange_bytes != nbytes:
        fail(f"the step graphs count {graphs.exchange_bytes} bytes exchanged, the buffers "
             f"hold {nbytes}")

    # -- a. 20 steps, twice ------------------------------------------------------------------
    table = [[(i * CARDS_VIEWS + j) % n_views for j in range(CARDS_VIEWS)]
             for i in range(CARDS_STEPS)]
    losses = []
    for turn in range(2):
        f_s, f_n = graphs.fused_seconds, graphs.fused_steps
        torch.cuda.reset_peak_memory_stats()
        _, m, dt = run(table)
        losses.append(m["total"].double().cpu().numpy())
        print(f"turn {turn + 1}: {CARDS_STEPS} steps of {CARDS_VIEWS} views in {dt:.4f} s, "
              f"{dt / CARDS_STEPS * 1e3:.3f} ms/step (host clock), device "
              f"{(graphs.fused_seconds - f_s) / (graphs.fused_steps - f_n) * 1e3:.3f} ms/step "
              f"(CUDA events around the replays); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB", flush=True)
    err = float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1])))
    print(f"two turns of {CARDS_STEPS} steps: largest loss error over value {err:.3g} (tol "
          f"{RANKS_CHUNK_TOL:g}); losses finite {all(np.isfinite(v).all() for v in losses)}",
          flush=True)
    if not err <= RANKS_CHUNK_TOL:
        fail("the two turns' losses disagree")
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.time()
    for _ in range(CARDS_STEPS):
        PS._exchange(probe)
    torch.cuda.synchronize()
    print(f"the exchange alone, eager over NCCL: "
          f"{(time.time() - t0) / CARDS_STEPS * 1e3:.3f} ms host each", flush=True)

    # -- d. launches on the device -----------------------------------------------------------
    check_step_launches("fused step", counts, graphs, steps_run[0], {}, views=per)

    # -- h. the fused step with device spans: the exchange span on every rank ---------------
    graphs.spans = True
    run(table)
    graphs.spans = False
    span_ms = graphs.span_ms()  # sums the chunk's stamps first
    names, stamps = graphs.last_stamps
    every = [None] * n
    dist.all_gather_object(every, span_ms.get(spans.EXCHANGE))
    print(f"fused step with device spans, rank {rank}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in span_ms.items()) + f" ms a step (sum "
        f"{sum(span_ms.values()):.4f}); exchange ms by rank {every}", flush=True)
    t = stamps[:, : len(names) + 1]
    if (list(span_ms) != list(spans.SPANS) + [spans.EXCHANGE]
            or names.count(spans.EXCHANGE) != 1 or bool((t[:, 1:] < t[:, :-1]).any())
            or None in every):
        fail(f"the fused step's spans on rank {rank}: {names}, {list(span_ms)}, {every}")

    # -- b. against one process, on rank 0 ---------------------------------------------------
    if rank == 0:
        one = T.StepGraphs(PS._local_batch_step)
        g1, mg = PS.parallel_train_steps_scan(ts, stacks, gt_stack, 0.0, opt_cfg, pipe_cfg,
                                              use_mask=False, mesh_shape=None, cam_geom=geom,
                                              rows=[views], graphs=one)

        def eager():
            return PS.parallel_train_step(ts, tuple(s[views] for s in stacks), gt_stack[views],
                                          0.0, opt_cfg, pipe_cfg, use_mask=False,
                                          mesh_shape=None, cam_geom=geom)

        (e1, _), (e2, _) = eager(), eager()
        lg = float(mg["total"][0])
        print(f"{n}-rank fused step against the one-process B={CARDS_VIEWS} step: loss {lf:.8f} "
              f"vs {lg:.8f} (error over value {abs(lf - lg) / abs(lg):.3g}, tol {VIEW_TOL:g})",
              flush=True)
        if abs(lf - lg) > VIEW_TOL * abs(lg):
            fail(f"the {n}-rank step's loss disagrees with the one-process step's")
        state_within(f"{n}-rank fused step against one process", f1,
                     {"one-process graphed": g1, "one-process eager": e1}, e1, e2, VIEW_TOL)
        torch.cuda.synchronize()
        t0 = time.time()
        PS.parallel_train_steps_scan(ts, stacks, gt_stack, 0.0, opt_cfg, pipe_cfg,
                                     use_mask=False, mesh_shape=None, cam_geom=geom, rows=table,
                                     graphs=one)
        torch.cuda.synchronize()
        print(f"one-process B={CARDS_VIEWS} graphed steps on cuda:0 (the other ranks idle): "
              f"{(time.time() - t0) / CARDS_STEPS * 1e3:.3f} ms/step", flush=True)
        one.release()
    graphs.release()
    dist.barrier()

    # -- e. the driver over the N ranks ---------------------------------------------------
    a = TR.parse_args(DRIVER_ARGS)
    run_dir = os.path.join(CARDS_DIR, "driver")
    scan = LOOP.parallel_train_steps_scan
    chunks = [0]

    def checked(*args, **kw):
        out = scan(*args, **kw)
        replicated(out[0], f"after the driver's chunk {chunks[0]}")
        chunks[0] += 1
        return out

    LOOP.parallel_train_steps_scan = checked
    writes.on = True
    torch.cuda.reset_peak_memory_stats()
    try:
        res, c = run_path(f"{n}-rank driver", lambda: TR.main(
            DRIVER_ARGS + ["--model-path", run_dir, "--views-per-step", str(CARDS_VIEWS),
                           "--n-devices", str(n), "--device", str(dev)]),
            TRAIN_KERNELS + ("tile_blend_fwd",),
            ("tile_blend_bwd", "blend_moment_bwd", "blend_train_bwd_basis"))
    finally:
        LOOP.parallel_train_steps_scan = scan
        writes.on = False
    dist.barrier()  # rank 0's files are written
    check_step_launches(f"{n}-rank driver", c, res.graphs, a.iterations,
                        dict(tile_blend_fwd=a.synthetic_views), views=per,
                        renders=(res.render_graphs,
                                 2 * len(a.test_iterations) if rank == 0 else 0))
    launches = device_launches(c, res.graphs, res.render_graphs)
    if res.graphs.fused_step_ms is None or not all(
            cap.get("nccl_kernels", 0) >= 1 for cap in res.graphs.captures):
        fail(f"the {n}-rank driver ran steps outside the fused graph: "
             f"{[cap.get('nccl_kernels') for cap in res.graphs.captures]}")
    sec, it = res.seconds, int(res.ts.step)
    curves = int(res.ts.alive.sum())
    every = [None] * n
    dist.all_gather_object(every, curves)
    print(f"{n}-rank driver: {it} iterations, {it / sec['train']:.3f} it/s, "
          f"{CARDS_VIEWS * it / sec['train']:.3f} views/s (host clock over train_scene), "
          f"{chunks[0]} chunks each replicated bitwise; fused step "
          f"{res.graphs.fused_step_ms:.3f} ms device over {res.graphs.fused_steps} (captures "
          f"{len(res.graphs.captures)}, NCCL "
          f"kernels {[cap['nccl_kernels'] for cap in res.graphs.captures]}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; final curves on the ranks "
          f"{every}; host seconds by phase " + ", ".join(
              f"{k} {v:.3f}" for k, v in sec.items() if k != "train"), flush=True)
    if it != a.iterations or len(set(every)) != 1:
        fail(f"the {n}-rank driver did not end at its last iteration with one curve count")
    if rank == 0:
        if writes.paths.count("driver/eval.json") != 1:
            fail(f"rank 0 wrote eval.json {writes.paths.count('driver/eval.json')} times")
        with open(os.path.join(run_dir, "eval.json")) as fh:
            ev = json.load(fh)
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            totals = [json.loads(line).get("total") for line in fh]
        totals = [t for t in totals if t is not None]
        print(f"{n}-rank driver: logged loss first {totals[0]:.5f} last {totals[-1]:.5f}; "
              f"chamfer {ev['chamfer']:.5f}, F@0.01 {ev['fscore_0.01']:.4f}; rank 0 wrote "
              f"{len(writes.paths)} files", flush=True)
        if not (np.isfinite(totals).all() and np.isfinite(list(ev.values())).all()):
            fail(f"the {n}-rank driver's losses or eval.json are not finite")
    elif writes.paths:
        fail(f"rank {rank} wrote {writes.paths}")

    # -- f. render_curves over the N ranks ---------------------------------------------------
    edges = os.path.join(run_dir, "parametric_edges.json")
    writes.paths.clear()
    writes.on = True
    tp, c = run_path(f"render_curves --n-devices {n}", lambda: RV.render_curves(
        ["--edges", edges, "--out", os.path.join(CARDS_DIR, "curves"), "--n-devices", str(n),
         "--device", str(dev)], quiet=True), ("tile_blend_fwd",))
    writes.on = False
    n_frames = len(tp["sha256"])
    warm = check_render_graphs(f"render_curves --n-devices {n}", tp["graphs"], n_frames)
    k3_dev = device_launches(c, tp["graphs"])["tile_blend_fwd"]
    launches["tile_blend_fwd"] = k3_dev
    nccl = [cap.get("nccl_kernels", 0) for cap in tp["graphs"].captures]
    if k3_dev != n_frames + warm or bool(writes.paths) != (rank == 0) or min(nccl) < 1:
        fail(f"render_curves --n-devices {n} launched K3 {k3_dev} times on the device for "
             f"{n_frames} frames, its captures hold {nccl} NCCL kernels, rank {rank} wrote "
             f"{len(writes.paths)} files")
    if rank == 0:
        one_img = RV.render_curves(["--edges", edges, "--out", os.path.join(CARDS_DIR,
                                                                          "curves_one"),
                                    "--device", str(dev)], quiet=True)
        same = sum(x == y for x, y in zip(tp["sha256"], one_img["sha256"]))
        print(f"render_curves --n-devices {n} (each rank's band and the sum one captured "
              f"graph, NCCL kernels {nccl}): {n_frames} frames, "
              f"{np.mean(tp['render_seconds'][1:]) * 1e3:.3f} ms host a frame after the first "
              f"against {np.mean(one_img['render_seconds'][1:]) * 1e3:.3f} on one process; "
              f"frames bitwise equal to one process (SHA-256) {same} of {n_frames}", flush=True)
        if same != n_frames:
            fail(f"render_curves over {n} ranks is not bitwise one process's")
    dist.barrier()

    # -- g. the dry run ----------------------------------------------------------------------
    line = DRY.dryrun_multichip(n, dev)
    if rank == 0:
        print(line, flush=True)
    with open(os.path.join(CARDS_DIR, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": launches}, f)
    dist.barrier()
    print(f"rank {rank} done in {time.time() - t_start:.1f} s", flush=True)
    dist.destroy_process_group()


def small_check():
    """One step_grads on the card and on the CPU, float32, small scene."""
    H = W = 96
    rng = np.random.default_rng(1)
    pts = rng.uniform(0.2, 0.8, size=(24, 3)).astype(np.float32)
    gt = (rng.uniform(size=(H, W)) ** 4).astype(np.float32)
    out = {}
    for d in ("cpu", "cuda"):
        cams = synthetic.ring_cameras(1, H, W, device=d)
        st = cs.init_state(pts, n_views=1, n_gaussians=6, device=d)
        ts = T.init_train_state(st)
        out[d] = T.step_grads(ts, cams[0], torch.tensor(gt, device=d), 0.0, OptimizationConfig(),
                              PipelineConfig(tile_capacity=256, big_capacity=64), use_mask=True,
                              n_gaussians=6, conn_on=True)
    lc, lg = float(out["cpu"][0]), float(out["cuda"][0])
    errs = {k: (out["cuda"][2][k].cpu().double() - v.double()).abs().max().item()
            / max(v.double().abs().max().item(), 1e-30) for k, v in out["cpu"][2].items()}
    print(f"small step, card vs CPU: loss {lg:.8f} vs {lc:.8f}; grad errors over max {errs}",
          flush=True)
    # float32 on both sides; a pixel whose alpha or transmittance gate
    # flips between the two libm exps moves its gradients by up to ~1%
    if not (abs(lg - lc) <= 1e-5 * abs(lc) and max(errs.values()) <= 1e-2):
        fail("the training step on the card disagrees with the CPU step")


def profile_step(run, steps: int, label: str):
    """Time by CUDA kernel over the `steps` training steps run() makes
    (torch.profiler), and the device's busy share of the host clock over
    them (the profiler's own host cost included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / steps
    avg = prof.key_averages()
    print(avg.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    # kernel rows only: an operator's row repeats the time of the kernels it launched
    kern = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    print(f"profile {label}: device busy {busy_ms:.3f} ms per step of {wall_ms:.3f} ms on the "
          f"host clock ({100 * (1 - busy_ms / wall_ms):.1f}% idle) over {len(kern)} kernel "
          f"names, {sum(e.count for e in kern) / steps:.0f} launches per step", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.4f} ms/step "
              f"{e.count / steps:6.0f}x  {e.key[:90]}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cards"]:
        if len(sys.argv) < 3 or not sys.argv[2].isdigit():
            fail("--cards takes the number of cards: 2 or 4")
        if sys.argv[3:4] == ["--rank"]:
            cards_rank_main(int(sys.argv[2]), int(sys.argv[4]))
        else:
            cards_main(int(sys.argv[2]))
    else:
        main()
