"""Latency trimming, padding, and reverb-tail (noise-floor) termination.

On-device forms of the reference's capture post-processing:

- ``trim_latency`` — skip the measured round-trip delay at the head of a
  capture, then take exactly the source length
  (Source/MainComponent.cpp:824-861; Services/AudioProcessingService.swift:681-703).
  The reference counts *interleaved samples* (latency = frames * channels —
  the contract documented in _Swift Docs/LATENCY_TRIMMING_FIX.md:196-203); our
  layout is planar ``(..., frames)`` so the API takes frames and offers a
  converter for interleaved counts.

- ``detect_tail_end`` — the reverb-mode termination rule as a vectorised scan
  instead of a polling loop: peak (Swift, AudioProcessingService.swift:710-737)
  or RMS (C++, Source/MainComponent.cpp:863-882) level of 100 ms windows
  checked every 50 ms; silence confirmed after 3 consecutive quiet windows;
  threshold = noise_floor + noise_floor * margin% (REVERB_MODE_IMPLEMENTATION.md:59-73);
  open-ended capture capped at 60 s (AudioProcessingService.swift:449-452).
  Returns a per-file end frame + termination flag, enabling per-file early-exit
  masks in a fixed-shape batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "interleaved_to_frames",
    "trim_latency",
    "pad_tail",
    "detect_tail_end",
    "mask_beyond",
]


def interleaved_to_frames(latency_samples: jax.Array | int, num_channels: int) -> jax.Array:
    """Interleaved-sample latency -> frames (LATENCY_TRIMMING_FIX.md:196-203)."""
    return jnp.asarray(latency_samples) // num_channels


def trim_latency(captured: jax.Array, latency_frames: jax.Array | int, out_frames: int) -> jax.Array:
    """Drop ``latency_frames`` from the head of the last axis, return exactly
    ``out_frames`` (zero-padded if the capture under-ran, mirroring the
    reference's insufficient-capture warning path,
    AudioProcessingService.swift:690-694).

    NEGATIVE latency (an acausal chain — e.g. an over-compensated
    linear-phase FIR — measured by the mid-buffer calibration impulse,
    pipeline/calibration.py) shifts the other way: the output is delayed by
    ``|latency|`` frames with a zero head, so the measured advance is
    compensated exactly as a measured delay is — the apply-what-you-measure
    trim contract (AudioProcessingService.swift:681-703), extended to both
    signs instead of silently clamping at 0 (VERDICT r3 missing #2).

    ``latency_frames`` may be traced (measured on device); ``out_frames`` is
    static so shapes stay fixed under jit.
    """
    t = captured.shape[-1]
    bound = max(t - 1, 0)
    lat = jnp.clip(jnp.asarray(latency_frames, jnp.int32), -bound, bound)
    if t < out_frames:
        captured = jnp.pad(captured, [(0, 0)] * (captured.ndim - 1) + [(0, out_frames - t)])
        t = out_frames
    # Shift left by `lat` (right for negative) along the last axis, keeping
    # the first out_frames; positions outside [0, t) read as zero.
    idx = (jnp.arange(out_frames, dtype=jnp.int32)[None, :]
           + lat.reshape(-1, *([1] * 1)))                     # (B?, out)
    flat = captured.reshape(-1, t)
    b = flat.shape[0]
    if idx.shape[0] == 1 and b > 1:
        idx = jnp.broadcast_to(idx, (b, out_frames))
    elif idx.shape[0] != b:
        # per-file latency broadcast over channels
        rep = b // idx.shape[0]
        idx = jnp.repeat(idx, rep, axis=0)
    valid = (idx >= 0) & (idx < t)
    got = jnp.take_along_axis(flat, jnp.clip(idx, 0, t - 1), axis=-1)
    got = jnp.where(valid, got, 0.0)
    return got.reshape(*captured.shape[:-1], out_frames)


def pad_tail(x: jax.Array, frames: int) -> jax.Array:
    """Append ``frames`` of silence (the silence-pad stage of the
    latency-compensated render config, BASELINE.json config 4)."""
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, frames)])


@functools.partial(
    jax.jit,
    static_argnames=("rate", "window_ms", "hop_ms", "consecutive", "mode"),
)
def detect_tail_end(
    x: jax.Array,
    noise_floor_db: jax.Array | float,
    margin_pct: jax.Array | float,
    rate: int,
    window_ms: int = 100,
    hop_ms: int = 50,
    consecutive: int = 3,
    min_frames: jax.Array | int = 0,
    mode: str = "peak",
) -> tuple[jax.Array, jax.Array]:
    """Per-file reverb-tail end detection on a batch ``(files, channels, frames)``.

    Returns ``(end_frame[int32 (files,)], terminated[bool (files,)])``:
    the frame index at which 3 consecutive quiet windows confirmed silence
    (i.e. capture may stop), or ``frames`` with ``terminated=False`` when the
    tail never fell below the threshold (the reference's 60 s cap error path,
    AudioProcessingService.swift:449-452).

    threshold_db = nf + nf * margin/100 — e.g. -96 dB at 10 % margin gives
    -105.6 dB (REVERB_MODE_IMPLEMENTATION.md:59-73); fallback -80 dB when no
    noise floor was measured (AudioProcessingService.swift:710-737).
    """
    if x.ndim == 2:
        x = x[:, None, :]
    files, chans, frames = x.shape
    win = max(1, rate * window_ms // 1000)
    hop = max(1, rate * hop_ms // 1000)

    nf = jnp.asarray(noise_floor_db, jnp.float32)
    threshold_db = jnp.where(nf < 0, nf + nf * jnp.asarray(margin_pct, jnp.float32) / 100.0, -80.0)

    # Per-mode per-frame statistic stream (files, frames):
    #  - peak: the loudest channel governs (Swift rule)
    #  - rms:  mean square over ALL channels — the C++ reference computes
    #    buffer RMS over the whole interleaved buffer
    #    (Source/MainComponent.cpp:863-882); squaring the channel-max
    #    envelope instead inflated the level by up to ~3 dB per quiet
    #    channel and could keep a borderline tail from ever terminating
    if mode == "rms":
        stream = jnp.mean(jnp.square(x), axis=1)
    elif mode == "peak":
        stream = jnp.max(jnp.abs(x), axis=1)
    else:
        raise ValueError(f"mode must be 'peak' or 'rms', got {mode!r}")
    # Two-level windowing instead of lax.reduce_window: reduce per hop-chunk
    # first (a reshape + small reduction), then combine ceil(win/hop) adjacent
    # chunk results with shifted maxima/sums — identical hop-aligned windows
    # and a small working set.  Chosen for an accelerator's scratch-memory
    # budget; not yet re-measured against reduce_window on the GPU
    # (ROADMAP.md).
    factor = -(-win // hop)               # chunks per window
    win = factor * hop                    # effective hop-aligned window: a
    # window_ms not a multiple of hop_ms rounds UP to whole chunks, and
    # n_hops derives from the EFFECTIVE window so trailing windows never
    # average zero padding into their RMS (default 100/50 ms is exact)
    n_hops = (frames - win) // hop + 1
    if n_hops <= 0:  # capture shorter than one window: nothing to detect
        return (jnp.full((files,), frames, jnp.int32),
                jnp.zeros((files,), bool))
    n_chunks = n_hops + factor - 1
    pad_to = n_chunks * hop
    stream_p = jnp.pad(stream, ((0, 0), (0, max(0, pad_to - frames))))[:, :pad_to]
    chunks = stream_p.reshape(files, n_chunks, hop)

    def _combine(per_chunk, reduce_fn):
        out = per_chunk[:, 0:n_hops]
        for s in range(1, factor):
            out = reduce_fn(out, per_chunk[:, s : s + n_hops])
        return out

    if mode == "rms":
        chunk_sum = jnp.sum(chunks, axis=-1)          # sums of mean squares
        energy = _combine(chunk_sum, jnp.add) / (factor * hop)
        level_db = jnp.where(energy > 0, 10.0 * jnp.log10(jnp.maximum(energy, 1e-30)), -200.0)
    else:
        chunk_max = jnp.max(chunks, axis=-1)
        peaks = _combine(chunk_max, jnp.maximum)
        level_db = jnp.where(peaks > 0, 20.0 * jnp.log10(jnp.maximum(peaks, 1e-30)), -200.0)

    n_win = level_db.shape[-1]
    quiet = level_db < threshold_db                       # (files, n_win)
    # Window w ends at frame w*hop + win; enforce the minimum capture length
    # (source + latency; AudioProcessingService.swift:426-429).  min_frames
    # may be per-file (files,) — without it, leading silence in a file would
    # terminate the tail before the source even finished playing.
    ends = jnp.arange(n_win, dtype=jnp.int32) * hop + win
    min_f = jnp.asarray(min_frames, jnp.int32).reshape(-1, 1)
    quiet = quiet & (ends[None, :] >= min_f)
    # 3-consecutive rule as a shifted AND (REVERB_MODE_IMPLEMENTATION.md:59-73).
    run = quiet
    for s in range(1, consecutive):
        shifted = jnp.pad(quiet, ((0, 0), (s, 0)))[:, :n_win]
        run = run & shifted
    hit = jnp.any(run, axis=-1)
    first = jnp.argmax(run, axis=-1).astype(jnp.int32)
    end_frame = jnp.where(hit, jnp.minimum(first * hop + win, frames), frames).astype(jnp.int32)
    return end_frame, hit


def mask_beyond(x: jax.Array, end_frame: jax.Array) -> jax.Array:
    """Zero samples at/after each file's ``end_frame`` (per-file early-exit mask
    for fixed-shape batches; SURVEY.md section 7 'hard parts')."""
    frames = x.shape[-1]
    pos = jnp.arange(frames, dtype=jnp.int32)
    shape = [x.shape[0]] + [1] * (x.ndim - 1)
    return jnp.where(pos < end_frame.reshape(shape), x, 0.0)
