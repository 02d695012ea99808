"""Analysis reductions: RMS, peak, noise floor, peak position, DC removal.

On-device equivalents of the reference's helper DSP:
- ``calculateRMS`` / ``calculateNoiseFloorDb`` (Source/MainComponent.cpp:950-1004,
  Services/LatencyMeasurementService.swift:173-181)
- ``findPeakPosition`` (Source/MainComponent.cpp:950-...; Swift
  ``analyzeCapturedAudio`` LatencyMeasurementService.swift:147-171)
- ``removeDCOffset`` mean subtraction (Source/MainComponent.cpp:884-902)

All reduce over the last (frames) axis and vectorise over leading
(files, channels) axes — the reference's per-channel loops become lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "rms",
    "rms_db",
    "peak",
    "peak_db",
    "noise_floor_db",
    "peak_position",
    "first_above",
    "remove_dc_offset",
    "DB_FLOOR",
]

#: dB value reported for exactly-zero signals (the reference's log10 guard).
DB_FLOOR = -200.0


def rms(x: jax.Array, axis: int = -1) -> jax.Array:
    """Root-mean-square over ``axis`` (Source/MainComponent.cpp:991-1004)."""
    return jnp.sqrt(jnp.mean(jnp.square(x), axis=axis))


def _amp_to_db(a: jax.Array) -> jax.Array:
    return jnp.where(a > 0, 20.0 * jnp.log10(jnp.maximum(a, 1e-30)), DB_FLOOR)


def rms_db(x: jax.Array, axis: int = -1) -> jax.Array:
    """RMS level in dBFS (C++ reverb check uses RMS dB; MainComponent.cpp:863-882)."""
    return _amp_to_db(rms(x, axis=axis))


def peak(x: jax.Array, axis: int = -1) -> jax.Array:
    """Absolute peak over ``axis``."""
    return jnp.max(jnp.abs(x), axis=axis)


def peak_db(x: jax.Array, axis: int = -1) -> jax.Array:
    """Peak level in dBFS (Swift reverb check uses peak dB;
    AudioProcessingService.swift:710-737)."""
    return _amp_to_db(peak(x, axis=axis))


def noise_floor_db(x: jax.Array, axis: int = -1) -> jax.Array:
    """Noise floor = RMS level in dB of a capture window
    (LatencyMeasurementService.swift:173-181)."""
    return rms_db(x, axis=axis)


def peak_position(x: jax.Array, axis: int = -1) -> jax.Array:
    """Index of the absolute peak (argmax |x|), as int32.

    The C++ latency completion converts the peak *frame* to interleaved samples
    by multiplying by the channel count (Source/MainComponent.cpp:275); we keep
    planar frames and leave any interleaved conversion to the caller.
    """
    return jnp.argmax(jnp.abs(x), axis=axis).astype(jnp.int32)


def first_above(x: jax.Array, threshold: float, axis: int = -1) -> jax.Array:
    """First index where ``|x| > threshold``; -1 when never exceeded.

    Mirrors the Swift impulse detector (threshold 0.1,
    LatencyMeasurementService.swift:147-171).
    """
    hit = jnp.abs(x) > threshold
    idx = jnp.argmax(hit, axis=axis).astype(jnp.int32)
    any_hit = jnp.any(hit, axis=axis)
    return jnp.where(any_hit, idx, jnp.int32(-1))


def remove_dc_offset(x: jax.Array, axis: int = -1) -> jax.Array:
    """Subtract the per-channel mean (Source/MainComponent.cpp:884-902)."""
    return x - jnp.mean(x, axis=axis, keepdims=True)
