"""The system under test, as the benchmark drives it: the program's training
chunk (``curve_gaussian_tpu_torch``), fed the benchmark's own inputs.

One view a step runs through ``engine/train.py::train_steps_scan``, the
driver's chunk; B views a step through
``parallel/sharding.py::parallel_train_steps_scan``, on one device or over
the N ranks of the process group (each rank passes its block of B/N views
of every step; over NCCL the step, its SUM and MAX collectives inside, is
one captured graph).  On a card every chunk replays the graph that the
first call captured (one ``StepGraphs`` is kept for the run, as
``train_scene`` keeps it between surgery events); on CPU tensors the same
body runs eagerly.  The chunk leaves its input state untouched.

This is the one module of a run that imports the program (``calibrate.py``
plants its faults in it).
"""
from __future__ import annotations

import dataclasses

from curve_gaussian_tpu_torch import config as C
from curve_gaussian_tpu_torch.engine import train as T
from curve_gaussian_tpu_torch.models import curve_state as cs
from curve_gaussian_tpu_torch.parallel import sharding as S


def optimization_config(config: dict) -> C.OptimizationConfig:
    """The program's optimization settings of the configuration's preset;
    raises where the file states another value than the preset holds (the
    reference reads the file)."""
    opt = C.PRESETS[config["preset"]]()
    for k, v in config["optimization"].items():
        if getattr(opt, k) != v:
            raise ValueError(f"the {config['preset']!r} preset holds {k}={getattr(opt, k)!r}, "
                             f"the configuration file {v!r}")
    return opt


class Program:
    """The program's training state and chunk over a benchmark scene."""

    def __init__(self, config: dict, traffic: dict, scene, ranks: int = 1, rank: int = 0):
        self.opt = optimization_config(config)
        self.pipe = dataclasses.replace(C.PipelineConfig(), **traffic["pipeline"])
        self.m = config["model"]["n_gaussians"]
        self.bg = 1.0 if config["model"]["white_background"] else 0.0
        self.phase = traffic["phase"]
        self.views_per_step = traffic["views_per_step"]
        cams = scene.cams
        self.stacks = (cams.w2c, cams.proj, cams.centers)
        self.geom = (cams.height, cams.width, cams.tanfovx, cams.tanfovy)
        self.gts = scene.gts
        self.ranks, self.rank = ranks, rank
        if self.views_per_step % ranks:
            raise ValueError(f"{self.views_per_step} views a step do not split over {ranks} ranks")
        step = S.batch_step(ranks) if self.views_per_step > 1 else None
        self.graphs = T.StepGraphs(step)

    def init_state(self, population) -> T.TrainState:
        """The program's training state of the benchmark's population at
        the phase's schedule iteration."""
        state = cs.CurveState(**population._asdict())
        return dataclasses.replace(T.init_train_state(state), step=self.phase["step"],
                                   opacity_frozen=self.phase["opacity_frozen"])

    def chunk(self, ts: T.TrainState, rows):
        """len(rows) steps from `ts`, step i over the views rows[i] (a list
        of ``views_per_step`` stack rows, of which this rank takes its
        block); returns (state, {metric: [k]})."""
        kw = dict(use_mask=self.phase["use_mask"], cam_geom=self.geom,
                  conn_on=self.phase["conn_on"], graphs=self.graphs)
        if self.views_per_step > 1:
            b = self.views_per_step // self.ranks
            mine = [r[self.rank * b:(self.rank + 1) * b] for r in rows]
            mesh = (("data", self.ranks),) if self.ranks > 1 else None
            return S.parallel_train_steps_scan(ts, self.stacks, self.gts, self.bg, self.opt,
                                               self.pipe, mesh_shape=mesh, rows=mine, **kw)
        return T.train_steps_scan(ts, self.stacks, self.gts, self.bg, self.opt, self.pipe,
                                  n_gaussians=self.m, rows=[r[0] for r in rows], **kw)

    @staticmethod
    def params(ts: T.TrainState) -> dict:
        return {k: v.detach().clone() for k, v in ts.params.items()}

    @staticmethod
    def first_moments(ts: T.TrainState) -> dict:
        return {k: v.detach().clone() for k, v in ts.opt.mu.items()}

    def release(self) -> None:
        self.graphs.release()
