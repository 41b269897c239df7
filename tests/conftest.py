"""Test configuration.

Tests run on CPU with an 8-device virtual mesh so sharding tests work
without GPUs.  The ``jax.config.update`` pins the CPU platform even where a
GPU is present; it runs before any backend is initialized.  The GPU paths
are exercised by ``python chip_smoke.py`` on the card.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
