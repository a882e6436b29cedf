"""Frame-to-model odometry: the configuration record.

Counterpart of ``elasticreconstruction_tpu/odometry/kinfu.py``. Only
:class:`OdometryConfig` is here: the pipeline configuration and the
registration stage read its health gates. ``track_frame`` and the rest of the
tracker are still to port.
"""

from __future__ import annotations

from typing import NamedTuple


class OdometryConfig(NamedTuple):
    """Tracker constants: the same fields and defaults as the JAX package's."""

    levels: int = 3
    iterations: tuple[int, ...] = (4, 5, 10)  # indexed by level; 0 = finest
    dist_threshold: float = 0.1  # max association distance (m)
    normal_threshold: float = 0.6  # min cos(angle) between normals
    depth_min: float = 0.1
    depth_max: float = 6.0
    raycast_steps: int = 192
    # Model-map downscale: raycast the model at 1/raycast_scale resolution and
    # associate full-res pixels against it.
    raycast_scale: int = 1
    damping: float = 1e-6
    min_support: float = 50.0  # matched pixels below which the GN update is skipped
    max_step: float = 0.5  # per-iteration |delta| clamp (rad / m) — trust region
    # Velocity-extrapolation gain for the tracking seed (the trusted velocity,
    # re-estimated only on frames whose tracking is healthy).
    velocity_gain: float = 1.0
    # Spectral-floor motion prior: eigendirections of the data normal equations
    # below prior_beta * lambda_max are topped up with a prior toward the seed.
    prior_beta: float = 0.05
    # Health gates for the trusted-velocity update and for the pipeline's
    # failure detection: obs_ratio below healthy_obs_ratio means a translation
    # direction is effectively unobservable.
    healthy_obs_ratio: float = 0.005
    healthy_fitness: float = 0.5
