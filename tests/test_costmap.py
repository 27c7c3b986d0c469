"""Costmap inflation/dilation vs NumPy mirrors of the reference loops and
cv2 (used strictly as a test oracle for the OpenCV-parity claims)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ros2_mpc_jax.ops import costmap


def ref_inflation_matrix(c, factor=1.3):
    """NumPy mirror of ros2_mpc/utils/costmap.py:44-59."""
    m = np.zeros((2 * c + 1, 2 * c + 1))
    m[c, c] = 100
    decay = (1 / c) / factor
    for k in range(c):
        m[k : m.shape[0] - k, k] = decay * (k + 1) * 100
        m[k : m.shape[0] - k, m.shape[0] - (k + 1)] = decay * (k + 1) * 100
        m[k, k : m.shape[1] - k] = decay * (k + 1) * 100
        m[m.shape[1] - (k + 1), k : m.shape[1] - k] = decay * (k + 1) * 100
    return m


def ref_inflate_global(occ, infl, c):
    """NumPy mirror of ros2_mpc/utils/costmap.py:5-20."""
    new = occ.copy()
    for i in range(occ.shape[0]):
        for j in range(occ.shape[1]):
            if occ[i, j] == 0:
                win = new[max(0, i - c) : min(occ.shape[0], i + c + 1), max(0, j - c) : min(occ.shape[1], j + c + 1)]
                if win.shape != infl.shape:
                    continue
                new[max(0, i - c) : min(occ.shape[0], i + c + 1), max(0, j - c) : min(occ.shape[1], j + c + 1)] = (
                    np.minimum(win, infl)
                )
    return new


@pytest.mark.parametrize("c", [2, 4, 7])
def test_inflation_matrix_matches_reference(c):
    got = np.asarray(costmap.get_inflation_matrix(c))
    np.testing.assert_allclose(got, ref_inflation_matrix(c), atol=1e-6)


def test_inflate_global_matches_reference_loop():
    rng = np.random.default_rng(3)
    occ = np.full((40, 50), 255.0)
    # sprinkle obstacles (value 0), some near borders
    idx = rng.integers(0, 40, size=15), rng.integers(0, 50, size=15)
    occ[idx] = 0.0
    occ[0, 0] = 0.0
    occ[39, 49] = 0.0
    c = 4
    infl = np.asarray(costmap.get_inflation_matrix(c))
    got = np.asarray(costmap.inflate_global(jnp.asarray(occ), jnp.asarray(infl), c))
    want = ref_inflate_global(occ, infl, c)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_inflate_local_crops_window():
    occ = np.full((100, 100), 255.0)
    occ[50, 50] = 0.0
    c = 3
    infl = costmap.get_inflation_matrix(c)
    out = np.asarray(
        costmap.inflate_local(jnp.asarray(occ), infl, c, jnp.array([50.0, 50.0]), 40)
    )
    assert out.shape == (40, 40)
    # obstacle lands at the window center (50 - (50-20) = 20)
    assert out[20, 20] == 0.0
    assert out[20, 21] < 255.0


def test_dilate_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    img = (rng.uniform(size=(30, 37)) > 0.9).astype(np.float32) * 100.0
    for k, iters in [(10, 1), (8, 2), (3, 1)]:
        want = cv2.dilate(img, np.ones((k, k), dtype=np.uint8), iterations=iters)
        got = np.asarray(costmap.dilate(jnp.asarray(img), k, iters), dtype=np.float32)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_erode_image_is_double_dilation():
    """Reference quirk #5: erode_image dilates (global_path_publisher.py:54-67)."""
    img = np.zeros((20, 20), dtype=np.float32)
    img[10, 10] = 255.0
    out = np.asarray(costmap.erode_image(jnp.asarray(img), 4))
    assert out.sum() > 255  # grew, not shrank
    assert out.dtype == np.uint8


def test_threshold_map_message():
    data = np.array([[0, 50, 61], [100, -1, 60]])
    img = costmap.threshold_map_message(data)
    # <=60 -> free(0), >60 -> occupied(255); then flipud
    want = np.flipud(np.array([[0, 0, 255], [255, 0, 0]], dtype=np.uint8))
    np.testing.assert_array_equal(img, want)
