"""Test configuration: hermetic CPU backend with an 8-device virtual mesh.

Mirrors the reference's stub-bridge strategy (CAAudioBridge.swift:139-264 —
a fake backend selected automatically when real hardware is unavailable):
the tests run on the CPU (``jax_platforms=cpu``) and need no GPU;
multi-device sharding tests run on 8 virtual CPU devices via
--xla_force_host_platform_device_count.  Tests marked ``gpu`` skip here;
the program's run on the card is ``python chip_smoke.py`` (``--four`` for
the four-card paths).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
