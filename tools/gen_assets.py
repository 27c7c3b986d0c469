"""Generate the package's shipped assets: the default params.yaml (reference
key parity, config/params.yaml:1-12) and the synthetic indoor map
(PGM + metadata yaml, the stand-in for the reference's maps/map_carto.*
cartographer asset — generated, not copied)."""

from __future__ import annotations

import os
import sys

import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ros2_mpc_jax.config import Params
from ros2_mpc_jax.utils import pgm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    params_path = os.path.join(REPO, "ros2_mpc_jax", "assets", "params.yaml")
    with open(params_path, "w") as fh:
        yaml.safe_dump(Params().to_yaml_dict(), fh, sort_keys=False)
    print("wrote", params_path)

    img = pgm.synthetic_indoor_map()
    map_pgm = os.path.join(REPO, "maps", "map_synthetic.pgm")
    pgm.write_pgm(map_pgm, img)
    print("wrote", map_pgm, img.shape)

    meta = {
        "image": "map_synthetic.pgm",
        "mode": "trinary",
        "resolution": pgm.DEFAULT_MAP_INFO["resolution"],
        "origin": pgm.DEFAULT_MAP_INFO["origin"] + [0],
        "negate": 0,
        "occupied_thresh": 0.65,
        "free_thresh": 0.25,
    }
    map_yaml = os.path.join(REPO, "maps", "map_synthetic.yaml")
    with open(map_yaml, "w") as fh:
        yaml.safe_dump(meta, fh, sort_keys=False)
    print("wrote", map_yaml)

    # real-scale cartographer-style home map (the repo's self-shipped
    # stand-in for the reference's maps/map_carto.* SLAM asset)
    home = pgm.synthetic_home_map()
    home_pgm = os.path.join(REPO, "maps", "map_home.pgm")
    pgm.write_pgm(home_pgm, home)
    print("wrote", home_pgm, home.shape)
    home_meta = {
        "image": "map_home.pgm",
        "mode": "trinary",
        "resolution": pgm.HOME_MAP_INFO["resolution"],
        "origin": pgm.HOME_MAP_INFO["origin"] + [0],
        "negate": 0,
        "occupied_thresh": 0.65,
        "free_thresh": 0.25,
    }
    home_yaml = os.path.join(REPO, "maps", "map_home.yaml")
    with open(home_yaml, "w") as fh:
        yaml.safe_dump(home_meta, fh, sort_keys=False)
    print("wrote", home_yaml)


if __name__ == "__main__":
    main()
