"""Configuration dataclasses, with the same fields and defaults as the JAX
package's ``config.py``.

The port keeps its own copy so that it imports nothing of the JAX package:
the dataclasses, the detector and dataset presets, and the argparse bridge
(``add_dataclass_args`` / ``dataclass_from_args``) the training CLI uses.
"""
from __future__ import annotations

import dataclasses
from argparse import ArgumentParser
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 0
    n_gaussians: int = 12  # Gaussians per curve (M)
    source_path: str = ""
    detector: str = "DexiNed"  # or 'PidiNet'
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    train_test_exp: bool = False
    eval: bool = False
    invert_edges: str = "auto"  # "auto" | "on" | "off"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    antialiasing: bool = False
    # gates the allmap/dir/alpha channels of eval renders; the training step
    # never renders them
    render_geo: bool = True
    debug: bool = False
    # max Gaussians kept per 32x32 pixel tile (the K nearest are kept)
    tile_capacity: int = 896
    # Gaussians whose clipped tile rect exceeds 4 tiles go to a second
    # binning tier of this many slots
    big_capacity: int = 256
    max_big_capacity: int = 8192
    backend: str = "pallas"  # the tile kernels; 'reference' renders through the oracle
    overflow_policy: str = "grow"  # 'grow' | 'raise' | 'warn'
    max_tile_capacity: int = 8192
    overflow_tolerance: float = 1e-4


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    iterations: int = 10_000
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    lr_curve_points_init: float = 5e-4
    lr_curve_points_final: float = 5e-6
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.025
    scaling_lr: float = 5e-3  # width LR
    mask_lr: float = 0.01
    exposure_lr_init: float = 0.01
    exposure_lr_final: float = 1e-3
    exposure_lr_delay_steps: int = 0
    exposure_lr_delay_mult: float = 0.0
    lambda_dssim: float = 0.1
    opacity_cull: float = 0.01
    opacity_cull_second: float = 0.05
    opacity_loss_weight: float = 0.01
    lambda_mse: float = 10.0
    lambda_curve_smo: float = 0.1
    lambda_points_conn: float = 0.1
    lambda_width: float = 0.01
    lambda_mask: float = 5e-4
    mask_threshold: float = 0.01
    merge_endpoints_flag: bool = True
    visible_checking: bool = False
    densification_interval: int = 2000
    densify_from_iter: int = 500
    densify_until_iter: int = 7000
    conn_from_iter: int = 7000
    densify_grad_threshold: float = 2000.0  # on accumulated NDC-grad sums
    random_background: bool = False
    width_floor: float = 5e-3
    conn_dist_threshold: float = 0.05
    threshold_line: float = 0.0015
    threshold_max_line: float = 0.005
    threshold_angle: float = 20.0
    threshold_angle_skip: float = 30.0
    distance_threshold: float = 0.02
    similarity_threshold: float = 0.97
    prune_trim_interval: int = 1000
    split_interval: int = 1000
    split_from_iter: int = 3000
    merge_interval: int = 1000


def pidinet_preset(opt: Optional[OptimizationConfig] = None) -> OptimizationConfig:
    """The PidiNet edge detector's settings."""
    o = opt or OptimizationConfig()
    return dataclasses.replace(
        o,
        lambda_mse=2.0,
        lambda_width=0.0,
        threshold_line=0.002,
        threshold_max_line=0.006,
        distance_threshold=0.03,
        similarity_threshold=0.95,
    )


def replica_preset(opt: Optional[OptimizationConfig] = None) -> OptimizationConfig:
    """The Replica scenes' settings."""
    o = opt or OptimizationConfig()
    return dataclasses.replace(
        o,
        opacity_cull=0.05,
        lambda_mse=1.0,
        lambda_width=0.0,
        threshold_line=2e-4,
        threshold_max_line=1e-3,
        similarity_threshold=0.95,
    )


def mv2cyl_preset(opt: Optional[OptimizationConfig] = None) -> OptimizationConfig:
    """The MV2Cyl scenes' settings."""
    o = opt or OptimizationConfig()
    return dataclasses.replace(o, lambda_points_conn=0.02)


PRESETS = {
    "default": lambda o=None: o or OptimizationConfig(),
    "pidinet": pidinet_preset,
    "replica": replica_preset,
    "mv2cyl": mv2cyl_preset,
}


def add_dataclass_args(parser: ArgumentParser, dc_type, prefix: str = "") -> None:
    """One ``--<prefix><field>`` flag per dataclass field (default None, so
    that an unset flag keeps the preset's value)."""
    for f in dataclasses.fields(dc_type):
        name = "--" + (prefix + f.name).replace("_", "-")
        if f.type in ("bool", bool):
            parser.add_argument(name, action="store_true", default=None)
        else:
            t = {"int": int, "float": float, "str": str}.get(str(f.type), None)
            if t is None:
                t = f.type if callable(f.type) else str
            parser.add_argument(name, type=t, default=None)


def dataclass_from_args(args, dc_type, base=None, prefix: str = ""):
    """``base`` with every field whose flag was given replaced."""
    base = base or dc_type()
    updates = {}
    for f in dataclasses.fields(dc_type):
        v = getattr(args, (prefix + f.name), None)
        if v is not None:
            updates[f.name] = v
    return dataclasses.replace(base, **updates)
