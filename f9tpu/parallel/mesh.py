"""Device mesh construction for the batch-resampling workload.

The reference is a single-process, single-device app (SURVEY.md section 2.4);
scale-out is a new, first-class subsystem.  Axis convention:

- ``files``   — data parallelism: independent files across devices (the
                dominant mode; zero cross-device traffic)
- ``frames``  — sequence parallelism: overlap-save chunking of one long file's
                frames axis with halo exchange via ppermute
                (`f9tpu.parallel.sharding.resample_frames_sharded`)
- ``channels``— MCFX-style channel-axis sharding for 8/16-channel buses
                (Docs/MultiChannel MCFX with JUCE.md:85-163)
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "files_sharding", "P", "Mesh", "NamedSharding"]


def make_mesh(
    num_files_shards: int | None = None,
    num_frames_shards: int = 1,
    num_channel_shards: int = 1,
    devices=None,
) -> Mesh:
    """Build a (files, frames, channels) mesh over available devices.

    Default: all devices on the files axis (pure data parallel).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if num_files_shards is None:
        num_files_shards = n // (num_frames_shards * num_channel_shards)
    total = num_files_shards * num_frames_shards * num_channel_shards
    if total != n:
        raise ValueError(
            f"mesh {num_files_shards}x{num_frames_shards}x{num_channel_shards}"
            f" != {n} devices")
    grid = devices.reshape(num_files_shards, num_frames_shards, num_channel_shards)
    return Mesh(grid, axis_names=("files", "frames", "channels"))


def files_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a (files, channels, frames) batch over the files axis."""
    return NamedSharding(mesh, P("files", None, None))
