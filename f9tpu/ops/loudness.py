"""EBU R128 / ITU-R BS.1770-4 metering on device: integrated loudness
(LUFS), loudness range (LRA), and true peak (dBTP).

The reference surfaces per-file levels (peak dB readouts in the file list,
Source/FileListAndLogComponent.cpp) — this module adds the metrics modern
mastering actually standardises on.

Pipeline (all on device, no recurrences):

1. Non-48 kHz input is resampled to 48 kHz with the framework's own SRC
   (the K-filter coefficients below are the standard's published 48 kHz
   set; resampling first sidesteps re-deriving them per rate).
2. K-weighting = the standard's two biquads (high shelf + high-pass),
   realised as one truncated float64 impulse response driven through the
   same FIR machinery as `ops.chain.Biquad` (a per-sample IIR would
   serialise the device; the cascade's poles give geometric decay, truncated
   far below the gating resolution).
3. ONE pass of 100 ms hop energies feeds BOTH statistics: integrated
   loudness uses 400 ms / 75 %-overlap blocks (4 consecutive hops) with
   -70 LUFS absolute + -10 LU relative gating; LRA (EBU Tech 3342) uses
   3 s windows at 1 s stride (30 hops, stride 10) with -70 / -20 LU gates
   and p95 - p10 of the survivors.
4. True peak (Annex 2) oversamples 4x — with this framework's windowed-sinc
   SRC, which IS the standard's reference method (a polyphase interpolator).

Reference coefficients: ITU-R BS.1770-4 Table 1/2 (48 kHz).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["integrated_lufs", "k_weighting_ir", "block_loudness",
           "true_peak_db", "loudness_range", "r128_stats",
           "meter_source_streamed", "array_reader", "surround_weights"]

#: BS.1770-4 stage 1: high-shelf (+~4 dB above ~1.5 kHz), 48 kHz.
K_STAGE1_B = (1.53512485958697, -2.69169618940638, 1.19839281085285)
K_STAGE1_A = (1.0, -1.69065929318241, 0.73248077421585)
#: BS.1770-4 stage 2: high-pass (~38 Hz), 48 kHz.
K_STAGE2_B = (1.0, -2.0, 1.0)
K_STAGE2_A = (1.0, -1.99004745483398, 0.99007225036621)

_RATE = 48000
_HOP = 4800                 # 100 ms
_I_BLOCK_HOPS = 4           # integrated: 400 ms blocks, 100 ms hop
_ST_BLOCK_HOPS = 30         # short-term: 3 s windows...
_ST_STRIDE_HOPS = 10        # ...at 1 s stride
_ABS_GATE_LUFS = -70.0
_REL_GATE_LU = -10.0
_LRA_REL_GATE_LU = -20.0
_OFFSET = -0.691


def _iir_response(b, a, n: int) -> np.ndarray:
    """First ``n`` samples of a biquad's impulse response, float64 exact."""
    h = np.zeros(n)
    x1 = x2 = y1 = y2 = 0.0
    for i in range(n):
        xn = 1.0 if i == 0 else 0.0
        yn = b[0] * xn + b[1] * x1 + b[2] * x2 - a[1] * y1 - a[2] * y2
        h[i] = yn
        x2, x1 = x1, xn
        y2, y1 = y1, yn
    return h


@functools.lru_cache(maxsize=1)
def k_weighting_ir() -> np.ndarray:
    """Truncated float64 IR of the K-weighting cascade at 48 kHz.

    The high-pass pole radius is ~0.995 -> the tail falls below 1e-9 within
    ~6000 samples (125 ms); truncation error is ~-180 dB on block energies,
    far beyond the gating resolution."""
    n = 8192
    h1 = _iir_response(K_STAGE1_B, K_STAGE1_A, n)
    h2 = _iir_response(K_STAGE2_B, K_STAGE2_A, n)
    h = np.convolve(h1, h2)[:n]
    # trim the negligible tail (keeps the device conv small)
    mag = np.abs(h)
    keep = int(np.max(np.nonzero(mag > mag.max() * 1e-9))) + 1
    return h[:keep]


def k_weight(x: jax.Array) -> jax.Array:
    """Apply the 48 kHz K-weighting cascade along the last axis.

    The ~5k-tap IR makes the direct form cost ~1 GFLOP per second of audio;
    above a short-signal threshold the partitioned-FFT convolver does the
    same work in far fewer operations."""
    from .chain import _direct_convolve, fft_convolve

    h = k_weighting_ir().astype(np.float32)
    if x.shape[-1] <= (1 << 16):
        return _direct_convolve(x, h)
    return fft_convolve(x, h)


def _bucket(n: int, lo: int = 64) -> int:
    """Next power-of-two >= max(n, lo): bounds the number of distinct XLA
    compiles across arbitrary file lengths (~12 buckets for 6 s..2 h)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def surround_weights(channels: int):
    """BS.1770-4 channel weights G_i for the standard 5.1 / 7.1 layouts our
    EXTENSIBLE writer emits (L R C LFE [BL BR] SL SR): fronts 1.0, surrounds
    1.41 (+1.5 dB), LFE excluded (weight 0).  Returns None for layouts the
    spec does not define (mono/stereo need no weighting; discrete MCFX
    buses are not 5.1 beds — weighting them would be wrong, which is why
    weighting is opt-in via ``cfg.surround_weights``)."""
    if channels == 6:
        return (1.0, 1.0, 1.0, 0.0, 1.41, 1.41)
    if channels == 8:
        return (1.0, 1.0, 1.0, 0.0, 1.41, 1.41, 1.41, 1.41)
    return None


def _apply_weights(hop_sq: jax.Array, weights):
    """Scale per-channel hop energies by the BS.1770 G_i weights (weighting
    mean-square energies post-hoc is algebraically identical to weighting
    the channels before summation)."""
    if weights is None:
        return hop_sq
    w = jnp.asarray(weights, jnp.float32).reshape(-1, 1)
    if w.shape[0] != hop_sq.shape[0]:
        raise ValueError(
            f"{w.shape[0]} channel weights for {hop_sq.shape[0]} channels")
    return hop_sq * w


def _hop_energies(x: jax.Array, rate: int):
    """The shared statistic base: SRC to 48 kHz if needed, K-weight, then
    per-channel 100 ms hop energy sums.

    Returns ``(hop_sq (C, n_bucket_hops), n_valid_hops)``: the signal is
    zero-padded to a power-of-two hop count so every file length in a bucket
    shares ONE compiled graph (per-file shapes would compile a fresh SRC +
    FIR graph per length — CLAUDE.md documents why that is unacceptable
    here), and the sub-hop tail (< 100 ms) is dropped.  Statistics mask
    windows by ``n_valid_hops`` (traced), which is exactly equivalent to
    computing on the hop-trimmed signal."""
    if x.ndim == 1:
        x = x[None]
    if rate != _RATE:
        from .resample import resample_rates

        x = resample_rates(x, int(rate), _RATE, quality="high")
    C, T = x.shape
    n_hops = T // _HOP
    if n_hops == 0:
        return jnp.zeros((C, 0), jnp.float32), 0
    nb = _bucket(n_hops)
    xp = jnp.pad(x[:, : n_hops * _HOP], ((0, 0), (0, nb * _HOP - n_hops * _HOP)))
    xk = k_weight(xp)
    hop_sq = jnp.sum(jnp.square(xk).reshape(C, nb, _HOP), axis=-1)
    return hop_sq, n_hops


def _windows_db(hop_sq: jax.Array, block_hops: int, stride_hops: int,
                n_valid_hops):
    """Channel-summed mean squares + loudness (dB) of sliding windows of
    ``block_hops`` hops at ``stride_hops`` stride, plus the validity mask
    for windows that end within the first ``n_valid_hops`` hops (windows
    reaching into the bucket's zero padding are excluded — identical to
    computing on the hop-trimmed signal)."""
    n_hops = hop_sq.shape[-1]
    n_blocks = max(0, (n_hops - block_hops) // stride_hops + 1)
    starts = jnp.arange(n_blocks) * stride_hops
    idx = starts[:, None] + jnp.arange(block_hops)[None, :]
    z = jnp.sum(jnp.sum(hop_sq[:, idx], axis=-1), axis=0) / (
        block_hops * _HOP)
    in_valid = (starts + block_hops) <= n_valid_hops
    return z, _OFFSET + 10.0 * jnp.log10(jnp.maximum(z, 1e-30)), in_valid


def block_loudness(x48: jax.Array, weights=None) -> jax.Array:
    """Per-block loudness (LUFS) of a 48 kHz signal ``(C, T)``: 400 ms
    blocks at 100 ms hop.  Returns ``(n_blocks,)``; blocks are summed over
    channels with unity weights (BS.1770 surround weights apply to >3-ch
    setups; this framework's buses are fullband channels)."""
    hop_sq, n_valid = _hop_energies(x48, _RATE)
    hop_sq = _apply_weights(hop_sq, weights)
    if n_valid < _I_BLOCK_HOPS:
        return jnp.full((0,), 0.0, jnp.float32)
    _, lb, _ = _windows_db(hop_sq, _I_BLOCK_HOPS, 1, n_valid)
    return lb[: n_valid - _I_BLOCK_HOPS + 1]


def _integrated_from_hops(hop_sq: jax.Array, n_valid) -> jax.Array:
    if hop_sq.shape[-1] < _I_BLOCK_HOPS or n_valid < _I_BLOCK_HOPS:
        return jnp.float32(-200.0)
    z, lb, in_valid = _windows_db(hop_sq, _I_BLOCK_HOPS, 1, n_valid)
    abs_mask = in_valid & (lb > _ABS_GATE_LUFS)
    n_abs = jnp.maximum(jnp.sum(abs_mask), 1)
    z_abs = jnp.sum(jnp.where(abs_mask, z, 0.0)) / n_abs
    rel = _OFFSET + 10.0 * jnp.log10(jnp.maximum(z_abs, 1e-30)) + _REL_GATE_LU
    mask = abs_mask & (lb > rel)
    n = jnp.sum(mask)
    z_gated = jnp.sum(jnp.where(mask, z, 0.0)) / jnp.maximum(n, 1)
    lufs = _OFFSET + 10.0 * jnp.log10(jnp.maximum(z_gated, 1e-30))
    return jnp.where(n > 0, lufs, jnp.float32(-200.0))


def _lra_from_hops(hop_sq: jax.Array, n_valid) -> jax.Array:
    if hop_sq.shape[-1] < _ST_BLOCK_HOPS or n_valid < _ST_BLOCK_HOPS:
        return jnp.float32(0.0)
    z, st, in_valid = _windows_db(hop_sq, _ST_BLOCK_HOPS, _ST_STRIDE_HOPS,
                                  n_valid)
    n_blocks = st.shape[0]
    abs_mask = in_valid & (st > _ABS_GATE_LUFS)
    n_abs = jnp.maximum(jnp.sum(abs_mask), 1)
    z_abs = jnp.sum(jnp.where(abs_mask, z, 0.0)) / n_abs
    rel = (_OFFSET + 10.0 * jnp.log10(jnp.maximum(z_abs, 1e-30))
           + _LRA_REL_GATE_LU)
    mask = abs_mask & (st > rel)
    # gated percentiles without dynamic shapes: sort with masked values
    # pushed to +inf, index by the (traced) count of surviving blocks
    n = jnp.sum(mask)
    st_sorted = jnp.sort(jnp.where(mask, st, jnp.inf))
    # rank policy: round-to-nearest (libebur128 / EBU reference meters);
    # plain floor biased p95 one rank low whenever frac(0.95*(n-1)) >= 0.5
    lo_i = jnp.clip((0.10 * (n - 1) + 0.5).astype(jnp.int32), 0, n_blocks - 1)
    hi_i = jnp.clip((0.95 * (n - 1) + 0.5).astype(jnp.int32), 0, n_blocks - 1)
    lra = st_sorted[hi_i] - st_sorted[lo_i]
    return jnp.where(n > 1, lra, jnp.float32(0.0))


def integrated_lufs(x: jax.Array, rate: int, weights=None) -> jax.Array:
    """BS.1770-4 integrated loudness of ``x`` (C, T) float32 at ``rate``.

    Returns a scalar (LUFS); silence/too-short input returns a -200 floor.
    Non-48 kHz input rides the framework's own SRC first.
    """
    hop_sq, n_valid = _hop_energies(x, rate)
    return _integrated_from_hops(_apply_weights(hop_sq, weights), n_valid)


def loudness_range(x: jax.Array, rate: int, weights=None) -> jax.Array:
    """Loudness range (LRA, LU) per EBU Tech 3342: short-term loudness
    (3 s windows, 1 s stride), absolute gate at -70 LUFS, relative gate at
    -20 LU below the gated mean, LRA = p95 - p10 of what survives."""
    hop_sq, n_valid = _hop_energies(x, rate)
    return _lra_from_hops(_apply_weights(hop_sq, weights), n_valid)


def r128_stats(x: jax.Array, rate: int, weights=None) -> tuple[float, float]:
    """(integrated LUFS, LRA) from ONE resample + K-weighting pass — both
    statistics derive from the same 100 ms hop energies."""
    hop_sq, n_valid = _hop_energies(x, rate)
    hop_sq = _apply_weights(hop_sq, weights)
    return (float(_integrated_from_hops(hop_sq, n_valid)),
            float(_lra_from_hops(hop_sq, n_valid)))


#: above this many input frames, true-peak scanning switches to fixed-size
#: chunks so device memory stays bounded (the whole-file form materialises
#: the 4x-oversampled signal, ~8x the input bytes — a ten-minute stereo file
#: under --normalize-tp could OOM the chip even though the peak is a simple
#: reduction)
_TP_CHUNK_THRESHOLD = 1 << 21


def true_peak_db(x: jax.Array, rate: int, oversample: int = 4) -> jax.Array:
    """True-peak level (dBTP, BS.1770-4 Annex 2): inter-sample peaks exposed
    by 4x oversampling — here the framework's own windowed-sinc SRC *is* the
    oversampler (the standard's reference method is exactly a polyphase
    interpolation filter).  Long signals scan in fixed overlap-save chunks
    (same halo math as `pipeline.stream`), so device memory is bounded
    regardless of file length; max is order-independent, so the chunked scan
    is exact."""
    from .resample import resample_rates

    if x.ndim == 1:
        x = x[None]
    T = x.shape[-1]
    if T > _TP_CHUNK_THRESHOLD:
        x_np = np.asarray(x)
        pk_db = _true_peak_chunked(array_reader(x_np), x_np.shape[0], T,
                                   int(rate), int(oversample))
        return jnp.float32(pk_db)
    # pad to a power-of-two length bucket: one compiled oversampler per size
    # class instead of one per file length (padding zeros cannot raise the
    # peak)
    nb = _bucket(T, lo=1 << 14)
    if nb > T:
        x = jnp.pad(x, ((0, 0), (0, nb - T)))
    y = resample_rates(x, int(rate), int(rate) * int(oversample),
                       quality="high")
    pk = jnp.max(jnp.abs(y))
    return 20.0 * jnp.log10(jnp.maximum(pk, 1e-30))


# --------------------------------------------------------------------------
# Streamed (chunk-exact) metering: the ONE measurement path used by BOTH the
# batch scheduler and the streaming pipeline when computing normalization
# gains, so a file processed either way receives the bit-identical gain and
# the two paths stay byte-identical (the dither contract).  Chunks ride the
# same overlap-save halo machinery as `pipeline.stream`.
# --------------------------------------------------------------------------


def array_reader(x: np.ndarray):
    """Adapter: an in-memory (C, T) array exposed with the `WavReader.read`
    contract (clipped at the ends, shorter at EOF)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None]

    def read(start: int, count: int) -> np.ndarray:
        start = max(0, start)
        return x[:, start : start + max(0, count)]

    return read


def _read_span(read, C: int, T: int, lo: int, length: int) -> np.ndarray:
    """(C, length) float32, zero-padded outside [0, T) — the host-side twin
    of the sharded streaming halo read (`pipeline.stream._stream_sharded`)."""
    out = np.zeros((C, length), np.float32)
    a, b = max(0, lo), min(T, lo + length)
    if b > a:
        blk = np.asarray(read(a, b - a), np.float32)
        out[:, a - lo : a - lo + blk.shape[1]] = blk
    return out


def _halos(bank) -> tuple[int, int]:
    left = bank.pad_front
    return left, max(0, bank.W - bank.M - left)


@functools.partial(jax.jit, static_argnames=("cycles", "rate_in", "ctx"))
def _meter48_step(xp: jax.Array, carry: jax.Array, *, cycles: int,
                  rate_in: int, ctx: int):
    """One metering chunk: SRC to 48 kHz (exact overlap-save), K-weight with
    carried context, 100 ms hop energies.  Returns (hop_sq (C, n), carry)."""
    from .resample import resample_presliced

    if rate_in != _RATE:
        from ..models.filters import design_cycle_bank

        bank = design_cycle_bank(rate_in, _RATE, quality="high")
        y = resample_presliced(xp, bank, cycles)
    else:
        y = xp
    z = jnp.concatenate([carry, y], axis=-1)
    kw = k_weight(z)[:, ctx:]
    C = kw.shape[0]
    hop_sq = jnp.sum(jnp.square(kw).reshape(C, -1, _HOP), axis=-1)
    return hop_sq, z[:, -ctx:]


@functools.partial(jax.jit, static_argnames=("cycles", "rate_in", "oversample"))
def _tp_step(xp: jax.Array, *, cycles: int, rate_in: int, oversample: int):
    from ..models.filters import design_cycle_bank
    from .resample import resample_presliced

    bank = design_cycle_bank(rate_in, rate_in * oversample, quality="high")
    y = resample_presliced(xp, bank, cycles)
    return jnp.max(jnp.abs(y))


def _meter_chunk_plan(rate: int, chunk_seconds: float, ctx: int):
    """(chunk_in_frames, cycles, bank48|None): chunk grid whose 48 kHz output
    span is a whole number of 100 ms hops and >= the K-weight context."""
    import math

    if rate == _RATE:
        chunk48 = max(1, int(chunk_seconds * _RATE) // _HOP) * _HOP
        while chunk48 < ctx + _HOP:
            chunk48 += _HOP
        return chunk48, chunk48, None
    from ..models.filters import design_cycle_bank

    bank = design_cycle_bank(rate, _RATE, quality="high")
    cyc_align = _HOP // math.gcd(bank.L, _HOP)   # cycles per hop boundary
    base_in = cyc_align * bank.M
    blocks = max(1, int(chunk_seconds * rate) // base_in)
    while blocks * cyc_align * bank.L < ctx + _HOP:
        blocks += 1
    return blocks * base_in, blocks * cyc_align, bank


def _true_peak_chunked(read, C: int, T: int, rate: int,
                       oversample: int = 4, chunk_seconds: float = 20.0) -> float:
    from ..models.filters import design_cycle_bank

    tp_bank = design_cycle_bank(rate, rate * oversample, quality="high")
    h_l, h_r = _halos(tp_bank)
    chunk_in = max(1, int(chunk_seconds * rate) // tp_bank.M) * tp_bank.M
    peaks = [0.0]
    start = 0
    while start < T:
        xp = _read_span(read, C, T, start - h_l, h_l + chunk_in + h_r)
        peaks.append(float(_tp_step(jnp.asarray(xp),
                                    cycles=chunk_in // tp_bank.M,
                                    rate_in=rate, oversample=oversample)))
        start += chunk_in
    # np.max propagates NaN (corrupt decode) exactly like the whole-file
    # path; Python's max(pk, nan) silently KEPT the finite value
    pk = float(np.max(peaks))
    return float(20.0 * np.log10(max(pk, 1e-30))) if not np.isnan(pk) \
        else float("nan")


def normalization_gain_db(target_lufs: float, source_lufs: float,
                          static_gain_db: float = 0.0,
                          tp_ceiling_db: float | None = None,
                          source_tp_db: float | None = None):
    """The ONE normalization-gain rule both the batch scheduler and the
    streaming pre-pass apply: per-file gain composing with the static
    cfg.gain_db so the NET output hits the target, clamped at +-40 dB, then
    reduced so (source true peak + net gain) respects the dBTP ceiling.
    Returns ``(gain_db, note)`` — note is a human-readable clamp/cap tag."""
    want = target_lufs - source_lufs - static_gain_db
    gain_db = float(np.clip(want, -40.0, 40.0))
    note = ("" if gain_db == want else
            ", clamped at +-40 dB — target missed by "
            f"{abs(want - gain_db):.1f} LU")
    if tp_ceiling_db is not None and source_tp_db is not None:
        over = source_tp_db + gain_db + static_gain_db - tp_ceiling_db
        if over > 0:
            gain_db -= over
            # append: a clamp note must survive when the cap also engages
            note += f", capped at {tp_ceiling_db:+.1f} dBTP"
    return gain_db, note


def meter_source_streamed(read, channels: int, frames: int, rate: int,
                          want_tp: bool = False,
                          chunk_seconds: float = 20.0,
                          weights=None) -> dict:
    """Integrated LUFS (and optionally true peak) of a source exposed via a
    ``read(start, count) -> (C, n)`` function, in constant memory.

    Chunk grid and device steps are fixed per (rate, chunk_seconds), so the
    result is a pure function of the samples — the batch scheduler (with
    `array_reader`) and the streaming pre-pass (with `WavReader.read`) get
    bit-identical floats, which keeps normalization gains — and therefore
    emitted bytes — identical across the two paths.

    ``want_tp`` shares the SAME host reads as the loudness pass (the
    pre-pass is LINK-bound; a second full read pass doubled its wall time).
    The true-peak value is exact regardless of the chunk grid: overlap-save
    chunks reproduce the oversampled samples exactly and max is
    order-independent.  ``weights``: optional BS.1770 G_i per-channel
    weights (see :func:`surround_weights`)."""
    ctx = int(k_weighting_ir().shape[0]) - 1
    chunk_in, cycles, bank = _meter_chunk_plan(rate, chunk_seconds, ctx)
    if bank is not None:
        h_l, h_r = _halos(bank)
        out48_total = bank.out_len(frames)
    else:
        h_l = h_r = 0
        out48_total = frames
    if want_tp:
        from ..models.filters import design_cycle_bank

        tp_bank = design_cycle_bank(rate, rate * 4, quality="high")
        th_l, th_r = _halos(tp_bank)
        tp_cycles = chunk_in // tp_bank.M      # tp_bank.M == 1
        peaks = [0.0]
    total_hops = out48_total // _HOP
    hops: list[np.ndarray] = []
    carry = jnp.zeros((channels, ctx), jnp.float32)
    start = 0
    got_hops = 0
    while start < frames:
        meter_more = got_hops < total_hops
        if not (meter_more or want_tp):
            break
        lo = start - max(h_l, th_l if want_tp else 0)
        hi = start + chunk_in + max(h_r, th_r if want_tp else 0)
        span = _read_span(read, channels, frames, lo, hi - lo)
        if meter_more:
            a = (start - h_l) - lo
            xp = span[:, a: a + h_l + chunk_in + h_r]
            hop_sq, carry = _meter48_step(jnp.asarray(xp), carry,
                                          cycles=cycles, rate_in=rate,
                                          ctx=ctx)
            hops.append(np.asarray(hop_sq))
            got_hops += hop_sq.shape[1]
        if want_tp:
            a = (start - th_l) - lo
            xtp = span[:, a: a + th_l + chunk_in + th_r]
            peaks.append(float(_tp_step(jnp.asarray(xtp), cycles=tp_cycles,
                                        rate_in=rate, oversample=4)))
        start += chunk_in
    out = {"lufs": -200.0, "true_peak_db": None}
    if total_hops >= _I_BLOCK_HOPS and hops:
        hop_all = np.concatenate(hops, axis=1)[:, :total_hops]
        nb = _bucket(total_hops)
        hop_pad = np.zeros((channels, nb), np.float32)
        hop_pad[:, :total_hops] = hop_all
        out["lufs"] = float(_integrated_from_hops(
            _apply_weights(jnp.asarray(hop_pad), weights), total_hops))
    if want_tp:
        pk = float(np.max(peaks))      # np.max propagates NaN (corruption)
        out["true_peak_db"] = (float(20.0 * np.log10(max(pk, 1e-30)))
                               if not np.isnan(pk) else float("nan"))
    return out
