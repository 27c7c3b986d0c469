"""Asset, PGM I/O, visualization, telemetry, and distributed-noop tests."""

import os

import numpy as np
import pytest

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.parallel import distributed
from ros2_mpc_jax.utils import Telemetry, flat_yaml, pgm, viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pgm_roundtrip(tmp_path):
    img = pgm.synthetic_indoor_map(60, 80, seed=1)
    path = str(tmp_path / "m.pgm")
    pgm.write_pgm(path, img)
    back = pgm.read_pgm(path)
    np.testing.assert_array_equal(back, img)


def test_read_ascii_pgm(tmp_path):
    path = str(tmp_path / "a.pgm")
    with open(path, "w") as fh:
        fh.write("P2\n# comment\n3 2\n255\n0 100 200\n254 205 0\n")
    img = pgm.read_pgm(path)
    np.testing.assert_array_equal(img, [[0, 100, 200], [254, 205, 0]])


def test_shipped_assets_load():
    p = Params.load(os.path.join(REPO, "ros2_mpc_jax", "assets", "params.yaml"))
    assert p.dt == 0.2 and p.N == 30 and p.Q == (1.0, 1.0, 0.005)
    img = pgm.read_pgm(os.path.join(REPO, "maps", "map_synthetic.pgm"))
    meta = pgm.load_map_yaml(os.path.join(REPO, "maps", "map_synthetic.yaml"))
    assert img.shape == (250, 250)
    assert meta["resolution"] == 0.05
    assert set(np.unique(img)) <= {0, 205, 254}


def test_params_yaml_roundtrip(tmp_path):
    p = Params(dt=0.1, N=15)
    path = str(tmp_path / "params.yaml")
    with open(path, "w") as fh:
        fh.writelines(f"{k}: {v}\n" for k, v in p.to_yaml_dict().items())
    p2 = Params.load(path)
    assert p2.dt == 0.1 and p2.N == 15
    assert p2.n_obstacle_points == p.n_obstacle_points


# the shipped files' contents as a YAML library parses them
_MAP_META = {"mode": "trinary", "resolution": 0.05, "negate": 0,
             "occupied_thresh": 0.65, "free_thresh": 0.25}


@pytest.mark.parametrize(
    "rel, expected",
    [
        (
            "ros2_mpc_jax/assets/params.yaml",
            {"dt": 0.2, "N": 30, "Q": [1.0, 1.0, 0.005], "R": [1.0, 1.0],
             "resolution": 0.05, "cost_factor": 0.5, "costmap_size": 2.0,
             "inflation_radius": 0.2, "reverse_factor": 5.0, "rotation_factor": 2.0,
             "look_ahead_distance": 0.5, "goal_threshold": 0.2},
        ),
        ("maps/map_home.yaml",
         {"image": "map_home.pgm", "origin": [-5.6, -7.85, 0], **_MAP_META}),
        ("maps/map_synthetic.yaml",
         {"image": "map_synthetic.pgm", "origin": [-6.25, -6.25, 0], **_MAP_META}),
    ],
)
def test_flat_yaml_reads_shipped_files(rel, expected):
    got = flat_yaml.load(os.path.join(REPO, rel))
    assert got == expected
    assert all(type(got[k]) is type(v) for k, v in expected.items())


def test_flat_yaml_inline_lists_comments_and_errors():
    text = "# map\nimage: 'a b.pgm'  # quoted\norigin: [-1.5, 2, 0]\nempty: []\nflag: true\n"
    assert flat_yaml.loads(text) == {
        "image": "a b.pgm", "origin": [-1.5, 2, 0], "empty": [], "flag": True
    }
    with pytest.raises(ValueError, match="nested"):
        flat_yaml.loads("a:\n  b: 1\n")
    with pytest.raises(ValueError, match="outside a list"):
        flat_yaml.loads("- 1\n")


def test_map_paths_default_to_packaged_map():
    pgm_path, yaml_path = pgm.map_paths({})
    assert os.path.samefile(pgm_path, os.path.join(REPO, "maps", "map_synthetic.pgm"))
    assert os.path.samefile(yaml_path, os.path.join(REPO, "maps", "map_synthetic.yaml"))


def test_map_server_loads_the_map_the_variables_name(tmp_path):
    from ros2_mpc_jax.nodes.bus import MessageBus
    from ros2_mpc_jax.nodes.map_server import MapServerNode

    img = pgm.synthetic_indoor_map(80, 100, seed=3)
    pgm.write_pgm(str(tmp_path / "m.pgm"), img)
    (tmp_path / "m.yaml").write_text("image: m.pgm\nresolution: 0.1\norigin: [-2.0, -3.0, 0]\n")
    env = {pgm.MAP_PGM_VAR: str(tmp_path / "m.pgm"), pgm.MAP_YAML_VAR: str(tmp_path / "m.yaml")}
    pgm_path, yaml_path = pgm.map_paths(env)
    assert (pgm_path, yaml_path) == (env[pgm.MAP_PGM_VAR], env[pgm.MAP_YAML_VAR])
    node = MapServerNode(MessageBus(), map_pgm_path=pgm_path, map_yaml_path=yaml_path)
    assert node.map_image.shape == (80, 100)
    assert node.map_info == {"resolution": 0.1, "origin": [-2.0, -3.0]}


@pytest.mark.parametrize("stray", ["OLD_MPC_MAP_PGM", "OLD_MPC_MAP_YAML"])
def test_map_paths_refuse_a_map_variable_they_do_not_read(stray):
    with pytest.raises(RuntimeError, match=stray):
        pgm.map_paths({stray: "/elsewhere/map", pgm.MAP_PGM_VAR: "/x.pgm"})


def test_viz_render_png(tmp_path):
    img = pgm.synthetic_indoor_map(80, 80, seed=2)
    info = {"resolution": 0.05, "origin": [-2.0, -2.0]}
    trace = np.stack([np.linspace(-1, 1, 30), np.linspace(-1, 0.5, 30)], axis=1)
    out = str(tmp_path / "world.png")
    rgb = viz.render_world(img, info, robot_trace=trace, goal_xy=(1.0, 0.5), out_path=out)
    assert rgb.shape == (80, 80, 3)
    assert os.path.getsize(out) > 100
    with open(out, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
    # trace stamped in red
    assert (rgb[..., 0] == 220).any()


def test_telemetry_percentiles():
    t = Telemetry("x")
    for v in range(100):
        t.record(solve_s=v / 1000.0)
    p = t.percentiles("solve_s")
    assert 0.04 < p["p50"] < 0.06
    assert p["p99"] > 0.09
    s = t.summary()
    assert s["solve_s"]["max"] == 0.099


def test_distributed_noop_single_host():
    info = distributed.initialize()
    assert info["initialized"] is False
    assert info["process_count"] == 1
    assert info["global_devices"] == 8  # virtual CPU mesh
