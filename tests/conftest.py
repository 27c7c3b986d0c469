"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (the GPU path is exercised by
chip_smoke.py on the card); the environment must be set before the first
``import jax`` anywhere.
"""

import os

# jax may already be imported (e.g. by a plugin) when this runs, which would
# make an env-var override too late for jax's config snapshot, so the
# platform is also forced through jax.config; XLA_FLAGS is still read lazily
# at first backend init.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
