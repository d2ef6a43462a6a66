"""Configuration dataclasses, with the same fields and defaults as the JAX
package's ``config.py``.

The port keeps its own copy so that it imports nothing of the JAX package.
A few fields only mean something to later slices of the port (the
capacity-growth policy, the surgery thresholds); they are kept so that a
configuration carries across unchanged.
"""
from __future__ import annotations

import dataclasses


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
