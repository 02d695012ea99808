"""The fused per-batch device graph: decode buffers in, PCM codes + metrics out.

This is the on-device equivalent of the reference's per-file hot path
(AudioProcessingService.swift:339-536: play -> capture -> wait -> trim ->
write), collapsed into one jitted XLA graph over a fixed-shape batch
``(files, channels, frames)``:

    dc-remove -> [silence pad] -> SRC -> latency trim -> [tail detect] ->
    gain -> metrics -> TPDF dither + quantize

Everything fuses; the host only moves bytes.  Per-file variable lengths ride
through as (frames_in[i], end_frame[i]) masks so one compiled graph serves a
whole length bucket (SURVEY.md section 7, 'variable-length batches without
recompiles').
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from ..config import ProcessingConfig, recording_length
from ..models.filters import design_cycle_bank
from ..ops import analysis, dither
from ..ops.resample import resample_auto
from ..ops.trim import detect_tail_end, mask_beyond, trim_latency

__all__ = ["ProcessResult", "build_process_fn", "process_batch"]


@dataclasses.dataclass
class ProcessResult:
    """Device outputs for one batch (host-side views)."""

    codes: Any          # int32 PCM codes (or uint8 payload when packed):
                        # layout "flat": (files, channels, out_total)
                        # layout "rows": (files, channels, n_rows, L) — sample
                        # t at [..., t // L, t % L]; host reshape is free
    out_frames: Any     # (files,) int32 — valid output length per file
    tail_terminated: Any  # (files,) bool — reverb-mode silence confirmed
    peak_db: Any        # (files,) float32, pre-quantize
    rms_db: Any         # (files,) float32
    noise_floor_db: Any  # (files,) float32 (tail window RMS)
    layout: str = "flat"


def _metrics(y: jax.Array, out_frames: jax.Array) -> tuple[jax.Array, jax.Array]:
    # normalise RMS by each file's valid length, not the padded bucket —
    # masked zeros would otherwise deflate short files' levels
    flat = y.reshape(y.shape[0], -1)
    n_valid = (out_frames.astype(jnp.float32) * y.shape[1]).clip(1.0)
    rms = jnp.sqrt(jnp.sum(jnp.square(flat), axis=-1) / n_valid)
    rms_db = jnp.where(rms > 0, 20.0 * jnp.log10(jnp.maximum(rms, 1e-30)),
                       analysis.DB_FLOOR)
    return analysis.peak_db(flat), rms_db



def _front_end(x, frames_valid, routing, out_channels, raw_in):
    """Shared input stages for both layouts: on-device raw decode, mono
    fan-out, MCFX routing (Docs/MultiChannel MCFX with JUCE.md:85-163;
    mono->stereo read path Source/MainComponent.cpp:727-739), and zeroing
    beyond each file's true length."""
    if raw_in is not None:
        from ..ops.devcodec import unpack_pcm_interleaved

        in_channels, in_bits, in_big = (raw_in if len(raw_in) == 3
                                        else (*raw_in, False))
        x = unpack_pcm_interleaved(x, in_channels, in_bits,
                                   big_endian=in_big)
    files = x.shape[0]
    if out_channels is not None and x.shape[1] == 1 and out_channels != 1:
        x = jnp.broadcast_to(x, (files, out_channels, x.shape[-1]))
    if routing is not None:
        from ..ops.routing import route_channels

        x = route_channels(x, list(routing))
    return mask_beyond(x, frames_valid)


def _exact_out_valid(frames_valid, bank, out_total):
    """ceil(n*L/M) per file in exact int32 split arithmetic (fp32 would drop
    frames for minute-long files: n*L exceeds 2^24)."""
    if bank.L * bank.M >= 2**31:
        # r_mod*L below would wrap int32; only reachable for extreme
        # rational approximations of varispeed ratios
        raise ValueError(
            f"ratio {bank.L}/{bank.M} too fine for the batch graph's int32 "
            f"length math; re-resolve with a smaller max_denominator")
    q_div, r_mod = jnp.divmod(frames_valid, bank.M)
    out_valid = (q_div * bank.L
                 + (r_mod * bank.L + bank.M - 1) // bank.M).astype(jnp.int32)
    return jnp.minimum(out_valid, out_total)


@functools.partial(
    jax.jit,
    static_argnames=("rate_in", "rate_out", "cfg_key", "static_zero_latency",
                     "raw_in", "packed_out", "chain", "channel_axis"),
)
def _process_impl(
    x: jax.Array,
    frames_valid: jax.Array,
    latency_frames: jax.Array,
    noise_floor_db: jax.Array,
    key: jax.Array,
    *,
    rate_in: int,
    rate_out: int,
    cfg_key: tuple,
    static_zero_latency: bool = False,
    raw_in: tuple[int, int] | None = None,
    packed_out: bool = False,
    chain=None,
    channel_axis: str | None = None,
    gain_lin=None,
):
    (quality, kind, bits, do_dither, remove_dc, gain_db, trim_enabled,
     reverb_mode, margin_pct, tail_mode, tail_window_ms, tail_hop_ms,
     tail_consecutive, pad_frames, routing, out_channels) = cfg_key

    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    files = x.shape[0]
    x = _front_end(x, frames_valid, routing, out_channels, raw_in)
    if pad_frames:
        # Capture head-room for reverb tails: src + 5*latency rule
        # (Source/AppState.h:240-243), as explicit silence padding.
        x = jnp.pad(x, ((0, 0), (0, 0), (0, pad_frames)))

    y = resample_auto(x, bank)

    if chain is not None:
        # The insert loop: the user's processor stack runs in-graph on the
        # resampled signal, adding its real group delay (trimmed below) and
        # ring-out (landing in the padded capture head-room) — the device form
        # of play -> external chain -> capture
        # (AudioProcessingService.swift:339-536).
        y = chain.apply(y, rate_out)

    out_total = y.shape[-1]
    if trim_enabled and not static_zero_latency:
        # Chain delay compensation.  Skipped entirely (statically) when the
        # caller knows the chain is delay-free — the gather over the whole
        # output is the single most expensive non-SRC stage.
        y = trim_latency(y, latency_frames, out_total)

    out_valid = _exact_out_valid(frames_valid, bank, out_total)

    if reverb_mode:
        # loudest-channel envelope; under channel-axis sharding (shard_map
        # over an MCFX bus) the max spans all shards so every shard reaches
        # the identical per-file verdict
        mono_detect = jnp.max(jnp.abs(y), axis=1)
        if channel_axis is not None:
            mono_detect = jax.lax.pmax(mono_detect, channel_axis)
        end_frame, terminated = detect_tail_end(
            mono_detect,
            noise_floor_db,
            margin_pct,
            rate=rate_out,
            window_ms=tail_window_ms,
            hop_ms=tail_hop_ms,
            consecutive=tail_consecutive,
            # minimum capture = each file's full source span: quiet windows
            # during the source (e.g. a silent intro) must not terminate the
            # tail (the reference waits src+latency before checking,
            # AudioProcessingService.swift:426-429)
            min_frames=out_valid,
            mode=tail_mode,
        )
        # Tail may extend past the source length (that's the point) but never
        # past the padded capture; if never silent, keep the full capture
        # (the 60 s cap is enforced by the capture size upstream).
        out_frames = jnp.maximum(jnp.minimum(end_frame, out_total), out_valid)
        # an EMPTY file has no tail to ring: without this, the all-quiet
        # detector fires at win+(consecutive-1)*hop and ~0.2 s of pure
        # dither noise is written for a 0-frame input
        out_frames = jnp.where(out_valid > 0, out_frames, 0)
    else:
        end_frame = out_valid
        terminated = jnp.ones((files,), bool)
        out_frames = out_valid

    # ---- single-materialisation discipline: `y` is
    # the last full-size array written (barrier: stops XLA re-running the SRC
    # matmul per consumer); the DC-removed/gained signal `z` is a virtual
    # fused producer recomputed by each consumer pass ----
    vmask = jnp.arange(out_total, dtype=jnp.int32)[None, None, :] < (
        out_frames[:, None, None])
    ym = jnp.where(vmask, y, 0.0)
    if remove_dc:
        # DC removal comes AFTER tail detection, as in the reference (capture
        # -> detect during capture -> trim -> DC-remove -> write,
        # Source/MainComponent.cpp:751-805): subtracting the mean first would
        # shift in-file silence off zero and defeat the noise-floor detector.
        # Mean over each file's valid span only (masked samples contribute 0).
        # computed BEFORE the barrier: fuses into the producer pass
        mean = (jnp.sum(ym, axis=-1, keepdims=True)
                / jnp.maximum(out_frames, 1).reshape(files, 1, 1).astype(jnp.float32))
    else:
        mean = jnp.zeros((files, 1, 1), jnp.float32)
    y = jax.lax.optimization_barrier(ym)
    g = 10.0 ** (gain_db / 20.0) if gain_db else 1.0
    if gain_lin is not None:
        # per-file loudness-normalization gain (traced: no recompiles)
        g = g * gain_lin.reshape(files, 1, 1)
    z = jnp.where(vmask, (y - mean) * g, 0.0)

    if channel_axis is None:
        pk_db, level_db = _metrics(z, out_frames)
    else:
        # cross-shard per-file metrics: channels live on other chips
        flat = z.reshape(files, -1)
        c_total = z.shape[1] * jax.lax.axis_size(channel_axis)
        sumsq = jax.lax.psum(jnp.sum(jnp.square(flat), axis=-1), channel_axis)
        n_valid = (out_frames.astype(jnp.float32) * c_total).clip(1.0)
        rms = jnp.sqrt(sumsq / n_valid)
        level_db = jnp.where(rms > 0,
                             20.0 * jnp.log10(jnp.maximum(rms, 1e-30)),
                             analysis.DB_FLOOR)
        pk_db = analysis._amp_to_db(
            jax.lax.pmax(jnp.max(jnp.abs(flat), axis=-1), channel_axis))
    # Noise floor estimate: RMS of the last tail window of each file's valid
    # span (the role of calculateNoiseFloor, LatencyMeasurementService.swift:173-181).
    win = max(1, rate_out * tail_window_ms // 1000)
    mono = jnp.max(jnp.abs(z), axis=1)                          # (files, out_total)
    if channel_axis is not None:
        mono = jax.lax.pmax(mono, channel_axis)
    raw_pos = (out_frames[:, None] - win
               + jnp.arange(win, dtype=jnp.int32)[None, :])
    in_range = raw_pos >= 0            # short files have < win valid samples
    gathered = jnp.take_along_axis(
        mono, jnp.clip(raw_pos, 0, out_total - 1), axis=-1)
    n_tail = jnp.minimum(out_frames, win).astype(jnp.float32).clip(1.0)
    tail_rms = jnp.sqrt(jnp.sum(jnp.square(gathered) * in_range, axis=-1) / n_tail)
    nf_est = jnp.where(tail_rms > 0,
                       20.0 * jnp.log10(jnp.maximum(tail_rms, 1e-30)),
                       analysis.DB_FLOOR)
    if do_dither:
        # noise keyed by (file seed, GLOBAL channel, absolute output frame):
        # bytes are invariant to batching/chunking/sharding — the streaming
        # path emits the identical file (dither.tpdf_noise).  Under channel
        # sharding the local channel index must be offset by the shard's
        # position or shards would draw correlated noise.
        c_local = z.shape[1]
        cid = jnp.arange(c_local, dtype=jnp.uint32)
        if channel_axis is not None:
            cid = (jax.lax.axis_index(channel_axis).astype(jnp.uint32)
                   * jnp.uint32(c_local) + cid)
        cs = dither.channel_seeds(dither.noise_seeds(key, files), cid)
        pos_t = jnp.arange(out_total, dtype=jnp.int32)[None, None, :]
        codes = dither.quantize_noise(z, bits, cs[:, :, None], pos_t)
    else:
        codes = dither.quantize_noise(z, bits)
    codes = jnp.where(vmask, codes, 0)
    if routing is not None and any(r < 0 for r in routing):
        # routed-silent channels stay digital zero even under dither (the
        # reference writes true silence on unused channels)
        silent = jnp.asarray([r < 0 for r in routing]).reshape(1, -1, 1)
        codes = jnp.where(silent, 0, codes)
    if packed_out:
        # On-device encode: download 3 (24-bit) or 2 (16-bit) bytes/sample
        # instead of int32 codes.
        from ..ops.devcodec import pack_interleaved

        codes = pack_interleaved(codes, bits)
    return codes, out_frames, terminated, pk_db, level_db, nf_est


@functools.partial(
    jax.jit,
    static_argnames=("rate_in", "rate_out", "cfg_key", "raw_in",
                     "packed_out"),
)
def _process_impl_rows(
    x: jax.Array,
    frames_valid: jax.Array,
    key: jax.Array,
    *,
    rate_in: int,
    rate_out: int,
    cfg_key: tuple,
    raw_in: tuple[int, int] | None = None,
    packed_out: bool = False,
    gain_lin=None,
):
    """Rows-layout fast path (no reverb, zero chain latency).

    Keeps the SRC output in its native ``(files, C, n_rows, L)`` tiling all
    the way through masking, DC removal, metrics, and dither/quantize: the
    device-side flat reshape of an L-wide array costs ~10x the resampler
    itself when L is not 128-aligned, while a host-side reshape after D2H is
    free.  Output sample ``t`` of a file lives at ``[..., t // L, t % L]``.

    ``x`` may arrive 4-D ``(files, C, n_rows, M)`` — HOST-marshalled rows
    (see ``rows_marshal_plan``): the host memcpy replaces the device-side
    flat->rows retiling, and the SRC becomes one stacked-bank matmul + R
    fused row-shifted adds (``resample_rows_pre``).  Contract: marshalled buffers are zero outside
    each file's valid samples (fresh zero-filled staging per flush).
    """
    (quality, kind, bits, do_dither, remove_dc, gain_db, _trim_enabled,
     _reverb_mode, _margin_pct, _tail_mode, tail_window_ms, _tail_hop_ms,
     _tail_consecutive, _pad_frames, routing, out_channels) = cfg_key
    from ..ops.resample import resample_rows, resample_rows_pre

    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    files = x.shape[0]
    if x.ndim == 4 and raw_in is None:
        if out_channels is not None and x.shape[1] == 1 and out_channels != 1:
            x = jnp.broadcast_to(x, (files, out_channels, *x.shape[2:]))
        if routing is not None:
            import numpy as _np

            r_np = _np.asarray(routing, _np.int32)
            x = jnp.take(x, jnp.asarray(_np.where(r_np < 0, 0, r_np)), axis=1)
            silent4 = jnp.asarray(r_np < 0).reshape(1, -1, 1, 1)
            x = jnp.where(silent4, 0.0, x)
        if bank.G is None:
            # varispeed bank: host-marshalled overlapping cycle rows
            # (banded_rows_plan) through the banded evaluation — same
            # rows-tiling contract downstream, no device-side cycle
            # retiling
            from ..ops.resample import resample_banded_rows_pre

            y = resample_banded_rows_pre(x, bank)   # (files, C, Q, L)
        else:
            y = resample_rows_pre(x, bank)     # (files, C, n_out, L)
    else:
        x = _front_end(x, frames_valid, routing, out_channels, raw_in)
        y, _ = resample_rows(x, bank)      # (files, C, n_rows, L)
    C, n_rows, L = y.shape[1], y.shape[2], y.shape[3]
    out_total = n_rows * L
    out_valid = _exact_out_valid(frames_valid, bank, out_total)

    rowi = jax.lax.broadcasted_iota(jnp.int32, (n_rows, L), 0)
    coli = jax.lax.broadcasted_iota(jnp.int32, (n_rows, L), 1)
    pos = (rowi * L + coli)[None, None]                   # (1,1,n,L)
    valid = pos < out_valid.reshape(files, 1, 1, 1)

    # ---- HBM-traffic discipline: materialise the SRC
    # output exactly once (mask fused into the matmul epilogue; the barrier
    # stops XLA from *duplicating the convolution* into each consumer
    # fusion), then every later stage is a FUSED consumer of it.  The
    # DC-removed/gained signal `z` stays virtual — recomputed by each pass
    # instead of written back (an explicit z write+read costs one more full
    # HBM round trip) ----
    ym = jnp.where(valid, y, 0.0)
    if remove_dc:
        # computed BEFORE the barrier so XLA multi-output-fuses the sum into
        # the SRC epilogue (same pass that writes y): one full read saved
        # (147 MB at bench scale; flops unchanged — verified no conv
        # duplication via cost analysis)
        s1 = jnp.sum(ym, axis=(2, 3), keepdims=True)
        mean = s1 / jnp.maximum(out_valid, 1).reshape(files, 1, 1, 1).astype(jnp.float32)
    else:
        mean = jnp.zeros((files, 1, 1, 1), jnp.float32)
    y = jax.lax.optimization_barrier(ym)
    g = 10.0 ** (gain_db / 20.0) if gain_db else 1.0
    if gain_lin is not None:
        g = g * gain_lin.reshape(files, 1, 1, 1)
    z = jnp.where(valid, (y - mean) * g, 0.0)

    pk_db = analysis._amp_to_db(jnp.max(jnp.abs(z), axis=(1, 2, 3)))
    n_valid = (out_valid.astype(jnp.float32) * C).clip(1.0)
    level_db = analysis._amp_to_db(
        jnp.sqrt(jnp.sum(jnp.square(z), axis=(1, 2, 3)) / n_valid))
    # tail-window noise floor over [out-win, out) via a positional mask
    win = max(1, rate_out * tail_window_ms // 1000)
    tail_mask = (pos >= (out_valid.reshape(files, 1, 1, 1) - win)) & valid
    mono = jnp.max(jnp.abs(z), axis=1)                     # (files, n, L)
    # RMS over the VALID tail samples (a file shorter than one window has
    # fewer than `win` of them; dividing by `win` would understate the floor)
    n_tail = jnp.minimum(out_valid, win).astype(jnp.float32).clip(1.0)
    nf_est = analysis._amp_to_db(jnp.sqrt(
        jnp.sum(jnp.square(mono) * tail_mask[:, 0], axis=(1, 2)) / n_tail))

    if do_dither:
        # counter-hash TPDF noise keyed by (file seed, channel, output frame)
        # — byte-identical across runs, batch groupings, chunkings, and
        # backends, at a fraction of the cost of the threefry draw; `pos` is the
        # logical output frame index in the rows tiling, so this matches the
        # flat and streaming paths bit-for-bit (dither.tpdf_noise)
        cs = dither.channel_seeds(dither.noise_seeds(key, files), C)
        codes = dither.quantize_noise(z, bits, cs[:, :, None, None], pos)
    else:
        codes = dither.quantize_noise(z, bits)
    codes = jnp.where(valid, codes, 0)
    if routing is not None and any(r < 0 for r in routing):
        silent = jnp.asarray([r < 0 for r in routing]).reshape(1, -1, 1, 1)
        codes = jnp.where(silent, 0, codes)
    terminated = jnp.ones((files,), bool)
    if packed_out:
        # Device-side payload packing for the raw wire: a flat reshape
        # first gives the same wide byte vector the flat path downloads,
        # 3/4 (24-bit) or 1/2 (16-bit) of the int32 bytes.
        from ..ops.devcodec import pack_interleaved

        flat = codes.reshape(codes.shape[0], codes.shape[1], -1)
        return (pack_interleaved(flat, bits), out_valid, terminated,
                pk_db, level_db, nf_est)
    return codes, out_valid, terminated, pk_db, level_db, nf_est


def _cfg_key(cfg: ProcessingConfig, pad_frames: int) -> tuple:
    return (
        cfg.quality, cfg.kind, cfg.bits, cfg.dither, cfg.remove_dc,
        float(cfg.gain_db), cfg.trim_enabled, cfg.reverb_mode,
        float(cfg.noise_floor_margin_pct), cfg.tail_mode, cfg.tail_window_ms,
        cfg.tail_hop_ms, cfg.tail_consecutive, pad_frames,
        tuple(cfg.channel_routing) if cfg.channel_routing is not None else None,
        cfg.output_channels,
    )


def _default_pad_frames(cfg: ProcessingConfig, rate_in: int, latency_frames) -> int:
    """Capture head-room: src + lat + 4*lat (recording_length,
    Source/AppState.h:240-243) plus the chain's ring-out and filter tail.
    Reverb mode additionally guarantees room for one full detection run
    (window + consecutive hops — quiet windows only count once they end
    at/after the source span), bounded by the 60 s cap
    (AudioProcessingService.swift:449-452).  A chain needs head-room even in
    non-reverb mode: latency trim shifts the capture left by the measured
    delay, so without lat+tail extra frames the source's final samples would
    fall off the end (the reference's insufficient-capture warning path)."""
    # latency is measured in OUTPUT-rate frames (trim consumes it from y);
    # the pad is INPUT-rate frames — convert so the reference's src + 5*lat
    # head-room survives downsampling ratios.  Negative (acausal) latency
    # right-shifts and needs no extra tail head-room.
    lat_out = max(0, int(latency_frames)) if isinstance(latency_frames, int) else 0
    lat_in = -(-lat_out * rate_in // max(cfg.target_rate, 1))
    tail_in = 0
    if cfg.chain is not None:
        tail_out = int(cfg.chain.tail_frames(cfg.target_rate))
        tail_in = -(-tail_out * rate_in // max(cfg.target_rate, 1))
    cap = int(cfg.max_tail_seconds * rate_in)
    if not cfg.reverb_mode:
        if cfg.chain is None:
            return 0
        return min(recording_length(0, lat_in) + tail_in + 4096, cap)
    detect_ms = (cfg.tail_window_ms
                 + (cfg.tail_consecutive + 1) * cfg.tail_hop_ms + 100)
    detect_frames = detect_ms * rate_in // 1000
    # the detection run must fit AFTER the chain's ring-out: a tail that
    # decays right at the end of the pad could otherwise never accumulate
    # `consecutive` quiet windows and would read as never-terminated
    return min(
        recording_length(0, lat_in) + tail_in + detect_frames + 4096,
        cap,
    )


def process_batch(
    x: jax.Array,
    frames_valid: jax.Array,
    cfg: ProcessingConfig,
    rate_in: int,
    key: jax.Array,
    latency_frames: int | jax.Array = 0,
    pad_frames: int | None = None,
    noise_floor_db: float | None = None,
    rows_layout: bool = False,
    per_file_gain_db=None,
) -> ProcessResult:
    """Run one fixed-shape batch through the fused graph.

    ``x``: (files, channels, frames_in) float32, zero-padded per file to the
    bucket length; ``frames_valid``: (files,) int32 true lengths.
    ``noise_floor_db`` overrides ``cfg.noise_floor_db`` (e.g. a per-run
    measured floor) without recompiling.  ``rows_layout=True`` (non-reverb,
    zero-latency batches only) keeps codes in the SRC's native (n_rows, L)
    tiling — ~2x faster on device; flatten on the host (see ProcessResult).
    ``per_file_gain_db``: optional (files,) per-file output gain in dB
    (loudness normalization) — a traced array, so it never recompiles.
    """
    gain_lin = None
    if per_file_gain_db is not None:
        import numpy as _np

        gain_lin = jnp.asarray(
            10.0 ** (_np.asarray(per_file_gain_db, _np.float32) / 20.0))
    if noise_floor_db is None:
        noise_floor_db = cfg.noise_floor_db
    rows_ok = (rows_layout and not cfg.reverb_mode and cfg.chain is None
               and isinstance(latency_frames, int) and latency_frames == 0)
    if hasattr(x, "ndim") and x.ndim == 4 and not rows_ok:
        raise ValueError(
            "4-D rows-marshalled input requires the rows fast path "
            "(rows_layout=True, no reverb/chain, zero latency)")
    if rows_ok:
        codes, out_frames, terminated, pk, level, nf_est = _process_impl_rows(
            x,
            jnp.asarray(frames_valid, jnp.int32),
            key,
            rate_in=rate_in,
            rate_out=cfg.target_rate,
            cfg_key=_cfg_key(cfg, 0),
            gain_lin=gain_lin,
        )
        return ProcessResult(codes=codes, out_frames=out_frames,
                             tail_terminated=terminated, peak_db=pk,
                             rms_db=level, noise_floor_db=nf_est,
                             layout="rows")
    if pad_frames is None:
        pad_frames = _default_pad_frames(cfg, rate_in, latency_frames)
    nf = jnp.float32(noise_floor_db if noise_floor_db is not None else 1.0)
    codes, out_frames, terminated, pk, level, nf_est = _process_impl(
        x,
        jnp.asarray(frames_valid, jnp.int32),
        jnp.asarray(latency_frames, jnp.int32),
        nf,
        key,
        rate_in=rate_in,
        rate_out=cfg.target_rate,
        cfg_key=_cfg_key(cfg, pad_frames),
        static_zero_latency=isinstance(latency_frames, int) and latency_frames == 0,
        chain=cfg.chain,
        gain_lin=gain_lin,
    )
    return ProcessResult(
        codes=codes,
        out_frames=out_frames,
        tail_terminated=terminated,
        peak_db=pk,
        rms_db=level,
        noise_floor_db=nf_est,
    )


def process_batch_raw(
    raw: jax.Array,
    frames_valid: jax.Array,
    cfg: ProcessingConfig,
    rate_in: int,
    key: jax.Array,
    in_channels: int,
    in_bits: int,
    in_big_endian: bool = False,
    latency_frames: int | jax.Array = 0,
    noise_floor_db: float | None = None,
    rows_layout: bool = False,
) -> ProcessResult:
    """Raw-bytes fast path: uint8 interleaved PCM in, packed payload out.

    ``raw``: (files, bucket_frames * in_channels * in_bits//8) uint8.
    ``ProcessResult.codes`` holds the uint8 payload
    (files, out_total * out_channels * cfg.bits//8); slice each file to
    ``out_frames[i] * out_channels * cfg.bits//8`` and write after a WAV
    header.  Requires ``cfg.bits`` in (16, 24) — the on-device packer's
    wire formats (the 16-bit narrow wire moves 2 B/sample each way instead
    of float32/int32's 4; JUCE's writer wires 16-bit natively,
    Source/MainComponent.cpp:784-801).
    """
    if cfg.bits not in (16, 24):
        raise ValueError("packed output path requires bits in (16, 24)")
    if (rows_layout and not cfg.reverb_mode and cfg.chain is None
            and isinstance(latency_frames, int) and latency_frames == 0):
        codes, out_frames, terminated, pk, level, nf_est = _process_impl_rows(
            raw,
            jnp.asarray(frames_valid, jnp.int32),
            key,
            rate_in=rate_in,
            rate_out=cfg.target_rate,
            cfg_key=_cfg_key(cfg, 0),
            raw_in=(in_channels, in_bits, in_big_endian),
            packed_out=True,
        )
        # rows results on the raw wire pack ON DEVICE (via a flat reshape —
        # see _process_impl_rows) and download the 2/3-byte payload, so the
        # collector/encode treat this exactly like the flat payload path
        return ProcessResult(codes=codes, out_frames=out_frames,
                             tail_terminated=terminated, peak_db=pk,
                             rms_db=level, noise_floor_db=nf_est,
                             layout="flat")
    pad_frames = _default_pad_frames(cfg, rate_in, latency_frames)
    if noise_floor_db is None:
        noise_floor_db = cfg.noise_floor_db
    nf = jnp.float32(noise_floor_db if noise_floor_db is not None else 1.0)
    payload, out_frames, terminated, pk, level, nf_est = _process_impl(
        raw,
        jnp.asarray(frames_valid, jnp.int32),
        jnp.asarray(latency_frames, jnp.int32),
        nf,
        key,
        rate_in=rate_in,
        rate_out=cfg.target_rate,
        cfg_key=_cfg_key(cfg, pad_frames),
        static_zero_latency=isinstance(latency_frames, int) and latency_frames == 0,
        raw_in=(in_channels, in_bits, in_big_endian),
        packed_out=True,
        chain=cfg.chain,
    )
    return ProcessResult(
        codes=payload,
        out_frames=out_frames,
        tail_terminated=terminated,
        peak_db=pk,
        rms_db=level,
        noise_floor_db=nf_est,
    )


def build_process_fn(cfg: ProcessingConfig, rate_in: int):
    """Convenience: a partially-applied `process_batch` for one rate pair."""
    def fn(x, frames_valid, key, latency_frames=0):
        return process_batch(x, frames_valid, cfg, rate_in, key, latency_frames)
    return fn
