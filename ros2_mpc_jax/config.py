"""Typed configuration for the MPC framework.

The reference keeps one flat YAML dict (`/root/reference/config/params.yaml:1-12`)
that every consumer re-loads via the ament share directory, plus a number of
hardcoded constants scattered through the node scripts (control bounds,
slew limits, dilation kernel sizes, refresh periods). Here all of that is one
frozen, hashable dataclass so it can be closed over by ``jax.jit`` and
serialized for parameter sweeps.

Reference key-for-key parity:
  dt, N, Q, R, resolution, cost_factor, costmap_size, inflation_radius,
  reverse_factor, rotation_factor, look_ahead_distance, goal_threshold
  (config/params.yaml:1-12)

Hardcoded reference constants captured here explicitly:
  * tracking control bounds  v in [-0.1, 0.2], w in [-0.2, 0.2]
    (ros2_mpc/planner/local_planner_tracking.py:94-95)
  * point-stabilization bounds  v in [-0.05, 0.15], w in [-0.2, 0.2]
    (ros2_mpc/planner/local_planner_point_stabilization.py:101-102)
  * legacy point-stabilization bounds  v in [-0.2, 0.2], w in [-0.1, 0.1]
    (ros2_mpc/mpc_point_stabilization.py:80-83)
  * slew limit 0.03 per tick (ros2_mpc/scripts/path_follower_local_planner.py:197-203)
  * global path refresh 1.0 s (ros2_mpc/scripts/path_follower_local_planner.py:157)
  * dilation kernels: 8 (x2 iterations) for the global map
    (ros2_mpc/scripts/global_path_publisher.py:54-67,94), 10x10 for costmaps
    (ros2_mpc/core/local_costmap_publisher.py:34-35)
  * hardcoded tracking goal radius 0.15 m
    (ros2_mpc/scripts/path_follower_local_planner.py:206)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from .utils import flat_yaml


@dataclasses.dataclass(frozen=True)
class Params:
    """Mirror of the reference ``config/params.yaml`` plus hardcoded constants."""

    # --- config/params.yaml:1-12 ---
    dt: float = 0.2
    N: int = 30
    Q: tuple[float, float, float] = (1.0, 1.0, 0.005)
    R: tuple[float, float] = (1.0, 1.0)
    resolution: float = 0.05
    cost_factor: float = 0.5
    costmap_size: float = 2.0
    inflation_radius: float = 0.2
    reverse_factor: float = 5.0
    rotation_factor: float = 2.0
    look_ahead_distance: float = 0.5
    goal_threshold: float = 0.2

    # --- hardcoded in the reference, lifted into config ---
    tracking_v_bounds: tuple[float, float] = (-0.1, 0.2)
    tracking_w_bounds: tuple[float, float] = (-0.2, 0.2)
    pointstab_v_bounds: tuple[float, float] = (-0.05, 0.15)
    pointstab_w_bounds: tuple[float, float] = (-0.2, 0.2)
    legacy_v_bounds: tuple[float, float] = (-0.2, 0.2)
    legacy_w_bounds: tuple[float, float] = (-0.1, 0.1)
    slew_limit: float = 0.03
    path_refresh_period: float = 1.0
    map_dilation_kernel: int = 8
    map_dilation_iterations: int = 2
    costmap_dilation_kernel: int = 10
    tracking_goal_radius: float = 0.15
    state_publish_period: float = 0.05
    local_costmap_period: float = 0.1

    @property
    def n_obstacle_points(self) -> int:
        """Obstacle parameter vector length.

        ``int((costmap_size * 2) / resolution) * 2`` == 160 with defaults
        (ros2_mpc/planner/local_planner_point_stabilization.py:155-156).
        """
        return int((self.costmap_size * 2) / self.resolution) * 2

    @property
    def costmap_cells(self) -> int:
        """Cells per side of the local costmap grid: ``map_size/resolution`` with
        map_size = costmap_size * 2 (ros2_mpc/utils/utils.py:13)."""
        return int(self.costmap_size * 2 / self.resolution)

    def to_yaml_dict(self) -> dict:
        """The 12 reference YAML keys only (round-trippable with the reference)."""
        return {
            "dt": self.dt,
            "N": self.N,
            "Q": list(self.Q),
            "R": list(self.R),
            "resolution": self.resolution,
            "cost_factor": self.cost_factor,
            "costmap_size": self.costmap_size,
            "inflation_radius": self.inflation_radius,
            "reverse_factor": self.reverse_factor,
            "rotation_factor": self.rotation_factor,
            "look_ahead_distance": self.look_ahead_distance,
            "goal_threshold": self.goal_threshold,
        }

    @classmethod
    def from_yaml_dict(cls, d: dict, **overrides) -> "Params":
        known = {f.name for f in dataclasses.fields(cls)}
        kv = {k: v for k, v in d.items() if k in known}
        for key in ("Q", "R"):
            if key in kv and isinstance(kv[key], list):
                kv[key] = tuple(kv[key])
        kv.update(overrides)
        return cls(**kv)

    @classmethod
    def load(cls, path: Optional[str] = None, **overrides) -> "Params":
        """Load from a params.yaml (reference-format); defaults when absent."""
        if path is None:
            path = os.path.join(os.path.dirname(__file__), "assets", "params.yaml")
        if os.path.exists(path):
            return cls.from_yaml_dict(flat_yaml.load(path), **overrides)
        return cls(**overrides)


DEFAULT_PARAMS = Params()
