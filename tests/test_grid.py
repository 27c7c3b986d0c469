"""Property tests for the grid/scan kernels vs direct NumPy reimplementations
of the reference loops (ros2_mpc/utils/utils.py)."""

import jax.numpy as jnp
import numpy as np

from ros2_mpc_jax.ops import grid


def ref_scan_to_occ(ranges, angles, res, size, rotation=0.0):
    """NumPy mirror of utils/utils.py:5-43."""
    num_cells = int(size / res)
    occ = np.zeros((num_cells, num_cells))
    a = np.arange(len(ranges)) * (angles[1] - angles[0]) / len(ranges) + angles[0]
    x = ranges * np.cos(a)
    y = ranges * np.sin(a)
    rot = np.array([[np.cos(rotation), -np.sin(rotation)], [np.sin(rotation), np.cos(rotation)]])
    with np.errstate(invalid="ignore"):  # NaN/inf beams rotate like the reference loop
        x, y = rot @ np.vstack([x, y])
    x = np.where(np.isnan(x), 0.0, x)
    y = np.where(np.isnan(y), 0.0, y)
    x = np.where(np.isinf(x), np.max(x[~np.isinf(x)]), x)
    y = np.where(np.isinf(y), np.max(y[~np.isinf(y)]), y)
    xi = x + size / 2
    yi = y + size / 2
    for i in range(len(xi)):
        cx, cy = int(xi[i] / res), int(yi[i] / res)
        if 0 <= cx < num_cells and 0 <= cy < num_cells:
            occ[cy, cx] = 100
    return occ


def test_scan_to_occupancy_matches_reference_loop():
    rng = np.random.default_rng(2)
    ranges = rng.uniform(0.1, 3.0, size=360)
    ranges[10] = np.nan
    ranges[20] = np.inf
    angles = np.array([-np.pi, np.pi])
    res, size = 0.05, 4.0
    fn = grid.make_scan_to_occupancy(res, size)
    got = np.asarray(fn(jnp.asarray(ranges), jnp.asarray(angles), 0.3))
    want = ref_scan_to_occ(ranges, angles, res, size, 0.3)
    # JAX computes in float32, the oracle in float64: beams landing within a
    # few ULP of a cell boundary may rasterize one cell apart. Allow a small
    # disagreement budget instead of exact equality.
    ndiff = int(np.sum(got != want))
    assert ndiff <= 8, f"{ndiff} cells differ"
    assert abs(float(got.sum()) - float(want.sum())) <= 8 * 100


def test_scan_to_xy_finite_and_rotated():
    ranges = np.array([1.0, 2.0, np.inf, np.nan, 0.5])
    angles = np.array([0.0, np.pi])
    x, y = grid.scan_to_xy(jnp.asarray(ranges), jnp.asarray(angles), rotation=0.0)
    assert np.all(np.isfinite(np.asarray(x)))
    assert np.all(np.isfinite(np.asarray(y)))
    # First beam points along +x at range 1.
    np.testing.assert_allclose(float(x[0]), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(y[0]), 0.0, atol=1e-6)


def test_xy_to_occupancy_scatter():
    fn = grid.make_xy_to_occupancy(0.1, 20, 20)
    x = jnp.array([0.05, 0.95, -5.0])
    y = jnp.array([0.05, 0.55, 0.0])
    occ = np.asarray(fn(x, y, jnp.array([0.0, 0.0])))
    assert occ[0, 0] == 100.0
    assert occ[5, 9] == 100.0
    assert occ.sum() == 200.0  # out-of-range point dropped


def test_occupancy_xy_roundtrip():
    occ = np.zeros((10, 12))
    occ[3, 4] = 255
    occ[7, 1] = 255
    xs, ys = grid.convert_occ_grid_to_xy_coordinates(occ, 0.5, np.array([1.0, -2.0]))
    # Reference flips first: row r -> flipped row (H-1-r).
    want = {(4 * 0.5 + 1.0, (10 - 1 - 3) * 0.5 - 2.0), (1 * 0.5 + 1.0, (10 - 1 - 7) * 0.5 - 2.0)}
    got = set(zip([round(v, 6) for v in xs], [round(v, 6) for v in ys]))
    assert got == want


def test_convert_to_map_coordinates_matches_reference_loop():
    occ = np.zeros((7, 9))
    res = 0.05
    my, mx = grid.convert_to_map_coordinates(jnp.asarray(occ), res)
    origin = np.array([7 // 2, 9 // 2]) * res
    want_x = np.zeros_like(occ)
    want_y = np.zeros_like(occ)
    for i in range(7):
        for j in range(9):
            want_x[i, j] = -j * res + origin[1]
            want_y[i, j] = -i * res + origin[0]
    np.testing.assert_allclose(np.asarray(mx), want_x, atol=1e-6)
    np.testing.assert_allclose(np.asarray(my), want_y, atol=1e-6)


def test_euler_quaternion_roundtrip():
    yaw = 0.77
    z, w = grid.quaternion_from_yaw(yaw)
    r, p, y = grid.euler_from_quaternion(0.0, 0.0, z, w)
    np.testing.assert_allclose(float(y), yaw, atol=1e-6)
    np.testing.assert_allclose(float(r), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(p), 0.0, atol=1e-6)


def test_world_map_roundtrip():
    shape = (200, 300)
    origin = (-4.84, -6.61)
    res = 0.05
    wm = np.asarray(grid.world_to_map(1.0, 2.0, shape, origin, res))
    # world_to_map returns (col, row-from-top); map_to_world consumes
    # (row-from-top, col) paths (utils/utils.py:155-169).
    back = grid.map_to_world(np.array([[wm[1], wm[0]]]), shape, origin, res)
    np.testing.assert_allclose(back[0], [1.0, 2.0], atol=res + 1e-9)


def test_map_to_world_empty_returns_none():
    assert grid.map_to_world(np.zeros((0, 2)), (10, 10), (0.0, 0.0), 0.05) is None
