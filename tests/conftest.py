"""Test configuration: by default everything runs on the CPU with 8 virtual
devices, so the multi-device sharding tests run on one host (the standard
JAX substitute for a multi-device machine — SURVEY.md §4).
The GPU path is checked end to end by chip_smoke.py on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

# a pytest plugin may have imported jax before this conftest ran, freezing
# the env-derived platform choice — apply it through the config as well
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)
