"""ament_python build shim.

The canonical packaging metadata lives in pyproject.toml (pip install path).
This setup.py exists so `colcon build` in a ROS 2 Humble workspace treats the
repo as an ament_python package (package.xml declares the build type) and
installs the share-directory assets — config, maps, launch analogues — where
`ros2 run` / `get_package_share_directory` expect them, matching how the
reference package deployed (reference: setup.py:11-21 installs params.yaml,
maps, launch files to the share dir). Console scripts come from pyproject;
setuptools merges both sources.
"""

from setuptools import setup

package_name = "ros2_mpc_jax"

setup(
    data_files=[
        ("share/ament_index/resource_index/packages", ["resource/" + package_name]),
        ("share/" + package_name, ["package.xml"]),
        ("share/" + package_name + "/config", [
            "ros2_mpc_jax/assets/params.yaml",
            "config/rviz_jax_mpc.rviz",
        ]),
        ("share/" + package_name + "/maps", [
            "maps/map_synthetic.pgm",
            "maps/map_synthetic.yaml",
            "maps/map_home.pgm",
            "maps/map_home.yaml",
        ]),
    ],
)
