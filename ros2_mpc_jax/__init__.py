"""ros2_mpc_jax — a nonlinear MPC framework in JAX (accelerator: NVIDIA GPU).

Brand-new JAX/XLA/Pallas implementation of the capabilities of the
``nitesh-subedi/ros2_mpc`` reference (an MPC local planner for ROS 2
navigation): unicycle NMPC for point stabilization and path tracking with
costmap obstacle handling, grid A* global planning with path smoothing,
laser-scan costmap construction, and a ROS-shaped host shim — rebuilt around
a batched interior-point iLQR solver that scales from one real-time control
tick to Monte-Carlo sweeps sharded over a device mesh.
"""

from .config import Params, DEFAULT_PARAMS

__version__ = "0.1.0"
__all__ = ["Params", "DEFAULT_PARAMS", "__version__"]
