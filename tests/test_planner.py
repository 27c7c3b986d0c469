"""Global planner tests: native C++ A* vs NumPy fallback vs wavefront field,
plus API parity for the three reference planner classes."""

import numpy as np

from ros2_mpc_jax.planner import (
    AstarGlobalPlanner,
    AStarPlanner2,
    RRTGlobalPlanner,
    astar_path,
    get_points_on_lines,
    wavefront,
)
from ros2_mpc_jax.planner.astar_py import astar_path_py
from ros2_mpc_jax.planner.native import astar_path_native


def make_corridor(h=30, w=40):
    """Free grid with a wall and one gap."""
    weights = np.ones((h, w), dtype=np.float32)
    weights[:, 20] = 255.0
    weights[14, 20] = 1.0
    return weights


def path_cost(weights, path):
    return sum(weights[r, c] for r, c in path[1:])


def test_native_astar_builds_and_matches_python():
    weights = make_corridor()
    start, goal = (2, 2), (25, 35)
    native = astar_path_native(weights, start, goal)
    assert native is not None, "native A* library failed to build"
    py = astar_path_py(weights, start, goal)
    assert native.shape[0] > 0 and py.shape[0] > 0
    assert tuple(native[0]) == start and tuple(native[-1]) == goal
    # Optimal costs must agree even if tie-broken paths differ.
    assert abs(path_cost(weights, native) - path_cost(weights, py)) < 1e-4
    # Both must route through the single gap.
    assert [14, 20] in native.tolist()
    assert [14, 20] in py.tolist()


def test_astar_no_path():
    weights = np.ones((10, 10), dtype=np.float32)
    weights[:, 5] = np.inf
    p = astar_path_py(weights, (0, 0), (0, 9))
    assert p.shape[0] == 0


def test_astar_planner2_smooths_and_zips():
    planner = AStarPlanner2()
    img = np.zeros((40, 40))  # all free (0 -> weight 1)
    path = planner.get_path((2, 2), (35, 30), img)
    assert len(path) > 0
    ys = np.array([p[0] for p in path])
    xs = np.array([p[1] for p in path])
    assert xs[0] == 2 and xs[-1] == 30  # x column preserved unsmoothed
    assert abs(ys[0] - 2) < 2 and abs(ys[-1] - 35) < 2
    # Occupied cells (255) are expensive but passable, like pyastar2d weights.
    img2 = np.full((20, 20), 255.0)
    path2 = planner.get_path((0, 0), (5, 5), img2)
    assert len(path2) > 0


def test_astar_planner2_weight_remap_matches_reference():
    """map values: 1 -> 255, 0 -> 1 (global_planner.py:88-90). A wall of 1s
    should be avoided when a free detour exists."""
    planner = AStarPlanner2()
    img = np.zeros((30, 30))
    img[10, 5:25] = 1  # wall of "1" values -> weight 255
    path = planner.get_path((5, 15), (15, 15), img)
    rows_cols = {(int(round(p[0])), int(p[1])) for p in path}
    wall_hits = [rc for rc in rows_cols if rc[0] == 10 and 5 <= rc[1] < 25]
    assert len(wall_hits) == 0


def test_astar_global_planner_binary():
    grid = np.zeros((15, 15), dtype=bool)
    grid[7, 2:13] = True
    p = AstarGlobalPlanner().get_path((2, 7), (12, 7), grid)
    assert len(p) > 0
    assert p[0] == (2, 7) and p[-1] == (12, 7)
    assert all(not grid[r, c] for r, c in p)
    # blocked goal -> []
    assert AstarGlobalPlanner().get_path((2, 7), (7, 5), grid) == []


def test_bresenham_densification():
    pts = get_points_on_lines([[(0, 0), (4, 2)]])
    assert tuple(pts[0]) == (0, 0)
    assert tuple(pts[-1]) == (4, 2)
    diffs = np.abs(np.diff(pts, axis=0))
    assert diffs.max() <= 1  # 8-connected steps


def test_rrt_star_finds_route():
    og = np.zeros((60, 60))
    og[30, 0:50] = 1  # wall with right-side gap
    planner = RRTGlobalPlanner(og, n=800, seed=3)
    path = planner.get_path((5, 5), (55, 5))
    assert path.shape[0] > 0
    assert tuple(path[0]) == (5, 5)
    assert tuple(path[-1]) == (55, 5)
    assert all(og[r, c] == 0 for r, c in path)


def test_wavefront_matches_astar_cost():
    import jax.numpy as jnp

    weights = make_corridor()
    start, goal = (2, 2), (25, 35)
    field = np.asarray(wavefront.distance_field(jnp.asarray(weights), jnp.array(goal)))
    ap = astar_path(weights, start, goal)
    np.testing.assert_allclose(field[start], path_cost(weights, ap), rtol=1e-5)
    path = wavefront.extract_path(field, start)
    assert tuple(path[0]) == start and tuple(path[-1]) == goal


def test_wavefront_batched_goals():
    import jax.numpy as jnp

    weights = jnp.ones((20, 20))
    goals = jnp.array([[0, 0], [19, 19], [10, 5]])
    fields = np.asarray(wavefront.batched_distance_fields(weights, goals))
    assert fields.shape == (3, 20, 20)
    np.testing.assert_allclose(fields[0, 0, 0], 0.0)
    np.testing.assert_allclose(fields[1, 19, 19], 0.0)
    np.testing.assert_allclose(fields[0, 19, 19], 38.0)  # Manhattan distance
