"""The accelerator a measurement ran on.

Measurement entry points (`bench.py`, `chip_smoke.py`, `tools/hw_soak.py`)
need an NVIDIA GPU and fail without one: a number taken on the CPU backend
says nothing about the card.
"""

from __future__ import annotations

import subprocess

__all__ = ["card_lines", "require_gpu"]


def require_gpu(what: str, count: int = 1) -> list:
    """``jax.devices()`` if JAX sees at least ``count`` GPUs; otherwise a
    ``SystemExit`` naming what was found (no CPU fallback)."""
    import jax

    devs = jax.devices()
    gpus = [d for d in devs if d.platform == "gpu"]
    if len(gpus) < count:
        raise SystemExit(
            f"{what}: needs {count} NVIDIA GPU(s); JAX found "
            f"{len(gpus)} (devices: {devs}). No CPU fallback.")
    return devs


def card_lines() -> list[str]:
    """``name, power.limit`` per card, as ``nvidia-smi`` prints them (read
    by a child process, which stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
