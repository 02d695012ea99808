"""Rational sample-rate conversion as one dense matmul per output cycle.

The reference app's "resampling" is an analog hardware loop driven by a
real-time callback (reference: Services/AudioProcessingService.swift:339-536);
here it becomes a software SRC core.  The whole rational resampler — polyphase
windowed-sinc or Lagrange — is folded at design time into one dense cycle
matrix ``G`` of shape ``(W, L)`` (see `f9tpu.models.filters.design_cycle_bank`)
so the per-sample inner loops of a CPU interpolator become

    y[b, q*L : (q+1)*L] = x_padded[b, q*M : q*M + W] @ G

evaluated either as a strided convolution or, for the common banks, as a
plain GEMM over cycle rows (`resample_rows_pre`).  Layout is
``(batch*channels, frames)`` — the reference's per-channel loops
(CAAudioBridge.swift:555-624) become the batch dimension.

No data-dependent shapes: output length is a static function of input length,
so each (in_len, ratio, quality) triple compiles once and is cached by jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.filters import CycleBank, design_cycle_bank

__all__ = ["resample", "resample_auto", "resample_banded", "resample_gather",
           "resample_rates", "resample_rows", "resample_rows_pre",
           "rows_marshal_plan", "rows_pre_applicable", "stacked_bank_f32",
           "cycle_matrix_f32", "banded_rows_applicable", "banded_rows_plan",
           "resample_banded_rows_pre"]


@functools.lru_cache(maxsize=64)
def _g_f32_cached(bank: CycleBank) -> np.ndarray:
    if bank.G is None:
        raise RuntimeError(
            f"dense cycle matrix disabled for ratio {bank.L}/{bank.M} "
            f"(would be {bank.W}x{bank.L}); this bank runs via the banded "
            "path (resample_banded / resample_banded_rows_pre, dispatched "
            "automatically by resample / resample_auto)")
    return np.ascontiguousarray(bank.G, dtype=np.float32)


def cycle_matrix_f32(bank: CycleBank) -> np.ndarray:
    """The bank's cycle matrix as float32 (cached)."""
    return _g_f32_cached(bank)


@functools.lru_cache(maxsize=64)
def _h_rev_f32_cached(bank: CycleBank) -> np.ndarray:
    """Phase bank with the tap axis reversed, float32 (L, K): tap k of the
    gather path multiplies x_padded[base + k]."""
    return np.ascontiguousarray(bank.H[:, ::-1], dtype=np.float32)


def _cycle_budget(T: int, bank: CycleBank, out_len: int | None):
    """The one place the whole-signal padding math lives: resolve out_len,
    the cycle count Q, how much input to keep, and the front/back zero pads
    reaching exactly ``(Q-1)*M + W`` total.  Every entry point — the dense
    conv (`resample`, which applies the pads inside the conv), the gather
    and banded varispeed forms (which apply them via jnp.pad) — derives its
    numbers here."""
    L, M, W = bank.L, bank.M, bank.W
    if out_len is None:
        out_len = bank.out_len(T)
    Q = -(-out_len // L)
    padded = (Q - 1) * M + W
    pad_front = bank.pad_front
    keep_T = min(T, max(0, padded - pad_front))
    pad_back = padded - pad_front - keep_T
    return out_len, Q, keep_T, pad_front, pad_back


def _pad_for_cycles(x: jax.Array, bank: CycleBank, out_len: int | None):
    """`_cycle_budget` + the explicit jnp.pad: returns ``(out_len, padded)``
    — ``padded`` is None for empty in/out."""
    T = x.shape[-1]
    out_len, _Q, keep_T, pad_front, pad_back = _cycle_budget(T, bank, out_len)
    if T == 0 or out_len == 0:
        return out_len, None
    xp = jnp.pad(x[..., :keep_T],
                 [(0, 0)] * (x.ndim - 1) + [(pad_front, pad_back)])
    return out_len, xp


def _gather_core(xp: jax.Array, bank: CycleBank, n_out: int) -> jax.Array:
    """Phase-table resampling of an already-padded signal: no dense matrix.

    ``y[n] = sum_k Hrev[ph(n), k] * xp[base(n) + k]`` where, with
    ``r = delay_upsamples %% L``:  ``u = (n %% L)*M + r``,
    ``base(n) = (n // L)*M + u // L``, ``ph(n) = u %% L`` — identical output
    to the dense cycle-matrix contract (same design, same index math), but
    the tables are only (L, K), so varispeed ratios like 44100->44056
    (L/M = 11014/11025, dense matrix ~0.5 GB) stay cheap.  All index math is
    exact int32: requires L*M + L < 2^31 (guaranteed by resolve_ratio's
    max_denominator of 2^16).

    This is K fused gather+FMA passes over the output with no matmul;
    `_banded_core` is the production dispatch and this form exists as the
    independent numerical cross-check.
    """
    L, M, K = bank.L, bank.M, bank.taps_per_phase
    if L * M + L >= 2**31:
        raise ValueError(
            f"ratio {bank.L}/{bank.M} too fine for int32 gather index math")
    if xp.shape[-1] >= 2**31 or n_out >= 2**31:
        # the signal-length-scaled indices (base, arange) are int32 too;
        # beyond this they would silently wrap and gather garbage
        raise ValueError(
            f"signal too long for int32 gather index math "
            f"({xp.shape[-1]} in / {n_out} out frames)")
    lead = xp.shape[:-1]
    T_pad = xp.shape[-1]
    xf = xp.reshape(-1, T_pad)
    hrev = jnp.asarray(_h_rev_f32_cached(bank))            # (L, K)
    n = jnp.arange(n_out, dtype=jnp.int32)
    a, b = jnp.divmod(n, jnp.int32(L))
    u = b * jnp.int32(M) + jnp.int32(bank.delay_upsamples % L)
    base = a * jnp.int32(M) + u // jnp.int32(L)            # (n_out,)
    ph = u % jnp.int32(L)
    y = jnp.zeros((xf.shape[0], n_out), jnp.float32)
    for k in range(K):
        w_k = jnp.take(hrev[:, k], ph, axis=0)             # (n_out,)
        x_k = jnp.take(xf, jnp.minimum(base + k, T_pad - 1), axis=-1)
        y = y + x_k * w_k
    return y.reshape(*lead, n_out)


def resample_gather(x: jax.Array, bank: CycleBank,
                    out_len: int | None = None) -> jax.Array:
    """Drop-in equivalent of `resample` via the phase-table gather path.

    Kept as the independent cross-check of the varispeed index contract;
    production varispeed dispatch uses `resample_banded`."""
    out_len, xp = _pad_for_cycles(x, bank, out_len)
    if xp is None:
        return jnp.zeros((*x.shape[:-1], out_len), dtype=x.dtype)
    return _gather_core(xp, bank, out_len)


#: Outputs per banded segment.  Not yet re-measured on the GPU
#: (ROADMAP.md).
_BAND_SEG = 128
#: Segment input offsets are aligned DOWN to this granularity (the sub-tile
#: shift is folded into zero rows at the top of the segment's matrix).  The
#: flat and rows banded forms share the alignment, which is what makes them
#: bitwise identical.
_LANE = 128


@functools.lru_cache(maxsize=16)
def _banded_plan(bank: CycleBank):
    """Per-bank banded decomposition (host, cached).

    The cycle matrix's nonzero band is a monotone staircase: outputs
    p..p+127 of a cycle read only inputs [off(p), off(p+127)+K) — a window of
    w ~ 128*M/L + K samples.  Splitting each cycle into S overlapping
    128-output segments gives S small dense (w, 128) matrices (total
    S*w*128 floats ~ 10-15 MB even for L ~ 11k) evaluated as one batched
    einsum over statically-sliced input windows — no gathers, no 0.5 GB
    dense matrix.  This is the production path for varispeed ratios.

    Window offsets are ALIGNED: each segment's start is rounded down to a
    multiple of ``_LANE`` and the sub-tile shift becomes zero rows at the top
    of its matrix (w widens by up to 127; in practice the staircase drift is
    a few samples).  Because the flat path (`_banded_core`) and the
    marshalled rows path (`resample_banded_rows_pre`) then contract the
    *identical* (w,) windows against the *identical* matrices in the same
    order, the two paths produce bitwise-identical floats.
    """
    from ..models.filters import _cycle_tables

    L, M, K = bank.L, bank.M, bank.taps_per_phase
    seg = min(_BAND_SEG, L)
    off, ph = _cycle_tables(L, M, bank.delay_upsamples % L)
    hrev = _h_rev_f32_cached(bank)   # shared with the gather path
    S = max(1, -(-L // seg))
    p0s = [s * seg for s in range(S - 1)] + [L - seg]
    raw0 = [int(off[p0]) for p0 in p0s]
    in0 = [a - (a % _LANE) for a in raw0]          # lane-aligned starts
    w = int(max(int(off[p0 + seg - 1]) + K - in0[s]
                for s, p0 in enumerate(p0s)))
    w = -(-w // 8) * 8                             # sublane-granular contraction
    G = np.zeros((S, w, seg), np.float32)
    for s, p0 in enumerate(p0s):
        for c in range(seg):
            pp = p0 + c
            row = int(off[pp] - in0[s])
            G[s, row: row + K, c] = hrev[ph[pp]]
    # widest input coordinate any segment's fixed-w slice touches (may exceed
    # the bank's W for early segments, whose G rows there are zero)
    w_rows = int(max(in0)) + w
    return tuple(int(v) for v in in0), w, seg, w_rows, G


def _banded_eval_rows(rows: jax.Array, bank: CycleBank) -> jax.Array:
    """Segment windows + batched einsum + head/tail reassembly on cycle
    rows ``(..., Q, w_rows)`` -> ``(..., Q, L)``.  The ONE evaluation both
    banded entry points trace, so the flat and marshalled-rows forms are
    bitwise-identical by construction."""
    L = bank.L
    in0, w, seg, w_rows, G = _banded_plan(bank)
    S = len(in0)
    if rows.shape[-1] != w_rows:
        raise ValueError(f"cycle-row width {rows.shape[-1]} != plan {w_rows}")
    # One dot PER SEGMENT, each consuming an aligned slice of ``rows``
    # directly: stacking the windows into a (Q, S, w) tensor first
    # materialises ~3x the band bytes.  Slices fuse into the
    # dots; the only materialised intermediates are the outputs themselves.
    gs = jnp.asarray(G)                                      # (S, w, seg)
    ys = [jnp.einsum("...qw,wl->...ql", rows[..., a: a + w], gs[s],
                     precision=jax.lax.Precision.HIGHEST)
          for s, a in enumerate(in0)]
    if S == 1:
        return ys[0][..., (seg - L):]
    tail = ys[-1][..., (S * seg - L):]
    return jnp.concatenate(ys[:-1] + [tail], axis=-1)        # (..., Q, L)


def _banded_core(xp: jax.Array, bank: CycleBank, n_out: int) -> jax.Array:
    """Banded evaluation of an already-front-padded signal ``xp``; reads
    input coordinates [0, (Q-1)*M + W) and pads anything beyond."""
    L, M = bank.L, bank.M
    in0, w, seg, w_rows, G = _banded_plan(bank)
    Q = -(-n_out // L)
    nblk = -(-w_rows // M)
    need = (Q + nblk - 1) * M            # block i reads xp[i*M : (Q+i)*M]
    lead = xp.shape[:-1]
    if xp.shape[-1] < need:
        xp = jnp.pad(xp, [(0, 0)] * (xp.ndim - 1)
                     + [(0, need - xp.shape[-1])])
    # overlapped (Q, w_rows) cycle rows from nblk shifted contiguous reshapes
    blocks = [xp[..., i * M:(Q + i) * M].reshape(*lead, Q, M)
              for i in range(nblk)]
    rows = jnp.concatenate(blocks, axis=-1)[..., :w_rows]   # (..., Q, w_rows)
    y_cyc = _banded_eval_rows(rows, bank)
    return y_cyc.reshape(*lead, Q * L)[..., :n_out]


def banded_rows_applicable(bank: CycleBank) -> bool:
    """Can this bank run the host-marshalled banded rows fast path?  Meant
    for varispeed banks (no dense matrix); dense banks already have the
    faster `resample_rows_pre` form."""
    return bank.G is None and bank.L >= 8 and bank.L * bank.M < 2**31


def banded_rows_plan(bank: CycleBank, frames: int) -> tuple[int, int, int]:
    """``(n_rows, row_width, pad_front)`` for host-side marshalling of a
    ``frames``-long signal into overlapping cycle rows: row ``q`` holds
    ``padded[q*M : q*M + row_width]`` of the zero-padded signal (zeros
    outside ``[pad_front, pad_front + frames)``), e.g. via a strided
    window view of a flat staging buffer.  Feeding the result to
    `resample_banded_rows_pre` skips the device-side cycle retiling."""
    _in0, _w, _seg, w_rows, _G = _banded_plan(bank)
    n_out = bank.out_len(frames)
    return -(-n_out // bank.L), w_rows, bank.pad_front


def marshal_banded_rows(flat: np.ndarray, bank: CycleBank,
                        n_rows: int | None = None) -> np.ndarray:
    """Overlapping cycle rows from zero-padded flat staging ``(..., total)``:
    one strided window view + one contiguous copy — the host side of
    `resample_banded_rows_pre` (rows overlap by ``row_width - M``, ~1%
    duplicate bytes).  ``flat`` must already hold the signal at offset
    ``pad_front`` (see `banded_rows_plan`); ``n_rows`` caps the row count
    when the staging carries extra tail room.  The one shared marshal for
    the batch scheduler, both streaming loops, and the bench."""
    w_rows = _banded_plan(bank)[3]
    v = np.lib.stride_tricks.sliding_window_view(
        flat, w_rows, axis=-1)[..., ::bank.M, :]
    if n_rows is not None:
        v = v[..., :n_rows, :]
    return np.ascontiguousarray(v)


def resample_banded_rows_pre(xrows: jax.Array, bank: CycleBank) -> jax.Array:
    """Banded SRC on already rows-marshalled input: ``(..., Q, row_width)``
    -> ``(..., Q, L)`` cycle rows (logical output sample ``t`` lives at
    ``[..., t // L, t % L]``; the host flatten after D2H is free).  The
    varispeed twin of `resample_rows_pre`: bitwise-identical floats to
    `resample_banded` (shared `_banded_eval_rows`); the flat->cycle-rows
    retiling happens on the host as strided memcpys."""
    return _banded_eval_rows(xrows, bank)


def resample_banded(x: jax.Array, bank: CycleBank,
                    out_len: int | None = None) -> jax.Array:
    """Banded resampler — the production path for varispeed banks
    (``bank.G is None``); numerically the same design/contract as `resample`."""
    out_len, xp = _pad_for_cycles(x, bank, out_len)
    if xp is None:
        return jnp.zeros((*x.shape[:-1], out_len), dtype=x.dtype)
    return _banded_core(xp, bank, out_len)


def resample_presliced(xp: jax.Array, bank: CycleBank, num_cycles: int) -> jax.Array:
    """Core cycle conv on an *already padded/haloed* signal: no implicit padding.

    ``xp``: (..., T_padded) with T_padded >= (num_cycles-1)*M + W; returns
    (..., num_cycles * L).  Used directly by the frames-sharded overlap-save
    path (`f9tpu.parallel.sharding`), where halos arrive via ppermute instead
    of zero padding.
    """
    L, M, W = bank.L, bank.M, bank.W
    need = (num_cycles - 1) * M + W
    if xp.shape[-1] < need:
        raise ValueError(f"padded input too short: {xp.shape[-1]} < {need}")
    if bank.G is None:      # varispeed bank: banded path
        return _banded_core(xp, bank, num_cycles * L)
    lead = xp.shape[:-1]
    xb = xp.reshape(-1, 1, xp.shape[-1])
    g = jnp.asarray(cycle_matrix_f32(bank))
    rhs = g.T.reshape(L, 1, W)
    y = jax.lax.conv_general_dilated(
        xb[..., : need],
        rhs,
        window_strides=(M,),
        padding=((0, 0),),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.transpose(y, (0, 2, 1)).reshape(*lead, num_cycles * L)


def resample(x: jax.Array, bank: CycleBank, out_len: int | None = None) -> jax.Array:
    """Resample the last axis of ``x`` by the rational ratio of ``bank``.

    ``x``: float32 array, shape ``(..., T)``.  Returns ``(..., out_len)`` where
    ``out_len`` defaults to ``ceil(T * L / M)``.  Output sample ``n`` estimates
    the input at position ``n*M/L`` — zero overall delay (group-delay
    compensation is folded into the cycle matrix, mirroring the reference's
    latency-compensation contract, _Swift Docs/LATENCY_TRIMMING_FIX.md).
    """
    if bank.G is None:      # varispeed bank: banded path
        return resample_banded(x, bank, out_len=out_len)
    L, M, W = bank.L, bank.M, bank.W
    T = x.shape[-1]
    # When out_len is smaller than the natural length, keep_T trims the input
    # so the conv emits exactly Q cycles — extra cycles would corrupt the
    # (B, Q*L) reshape (mixing rows across batch entries) or fail outright.
    out_len, Q, keep_T, pad_front, pad_back = _cycle_budget(T, bank, out_len)
    if T == 0 or out_len == 0:
        return jnp.zeros((*x.shape[:-1], out_len), dtype=x.dtype)
    x = x[..., :keep_T]

    lead = x.shape[:-1]
    xb = x.reshape(-1, 1, keep_T)  # (B, C=1, T) for conv
    g = jnp.asarray(cycle_matrix_f32(bank))          # (W, L)
    rhs = g.T.reshape(L, 1, W)                       # (out_feat=L, in_feat=1, W)
    y = jax.lax.conv_general_dilated(
        xb,
        rhs,
        window_strides=(M,),
        padding=((pad_front, pad_back),),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        # HIGHEST = true fp32 (no TF32/bf16 passes): required for the
        # -120 dB parity target (BASELINE.md)
        precision=jax.lax.Precision.HIGHEST,
    )                                                # (B, L, Q)
    y = jnp.transpose(y, (0, 2, 1)).reshape(-1, Q * L)[:, :out_len]
    return y.reshape(*lead, out_len)


#: Most overlap rows (R) the rows form takes; beyond it the strided conv
#: serves.  Not yet re-measured on the GPU (ROADMAP.md).
_MAX_R = 8
#: Row-count granule of the rows GEMM: marshalled row counts are rounded up
#: to it, and `resample_rows_pre` pads any other count.  Rows in a partial
#: last block take another code path in XLA:CPU's GEMM that rounds
#: differently, and batch groupings and sharding must not change the SRC's
#: bits.
_ROW_BLOCK = 256


def _overlap_rows(bank: CycleBank) -> int:
    """R: input rows beyond its own that one output cycle reads."""
    return max(1, -(-(bank.taps_per_phase - 1) // bank.M))


def rows_pre_applicable(bank: CycleBank) -> bool:
    """Does the rows form (`resample_rows_pre`) serve this bank?  Degenerate
    tilings (tiny L or M, large overlap) and varispeed banks without a dense
    matrix take the strided conv / banded forms instead."""
    return (bank.dense_ok and _overlap_rows(bank) <= _MAX_R
            and bank.L >= 8 and bank.M >= 8)


@functools.lru_cache(maxsize=64)
def stacked_bank_f32(bank: CycleBank) -> np.ndarray:
    """The cycle bank restructured for the shift-after-dot rows form:
    ``((R+1)*L, M)`` where block r holds ``G[r*M:(r+1)*M].T`` (cached)."""
    L, M, W = bank.L, bank.M, bank.W
    R = _overlap_rows(bank)
    g = np.zeros(((R + 1) * M, L), np.float32)
    g[:W] = cycle_matrix_f32(bank)
    return np.ascontiguousarray(
        np.concatenate([g[r * M : (r + 1) * M].T for r in range(R + 1)], axis=0))


def rows_marshal_plan(bank: CycleBank, frames: int) -> tuple[int, int]:
    """(n_rows, pad_front) for host-side rows marshalling of a ``frames``-long
    signal: the host writes samples at flat offset ``pad_front`` of a
    zero-initialised ``(n_rows, M)`` buffer (a plain memcpy — rows are
    contiguous).  ``n_rows`` is a multiple of ``_ROW_BLOCK``; the rows past
    the signal's cycles are zeros."""
    q = -(-bank.out_len(frames) // bank.L)
    return _rows_for_cycles(bank, q), bank.pad_front


def _rows_for_cycles(bank: CycleBank, q: int) -> int:
    """Input rows for ``q`` output cycles, rounded up to ``_ROW_BLOCK``."""
    return -(-(q + _overlap_rows(bank)) // _ROW_BLOCK) * _ROW_BLOCK


def resample_rows_pre(xp3: jax.Array, bank: CycleBank,
                      precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """SRC on an already rows-marshalled input: ``xp3`` (..., n_rows, M) ->
    ``(..., n_rows - R, L)``.

    One plain GEMM against the stacked bank plus R fused row-shifted adds —
    ``out[q] = sum_r (xp3 @ G_r)[q + r]`` — because the cycle shift commutes
    with the matmul.  No strided conv and no im2col.
    """
    L, M = bank.L, bank.M
    R = _overlap_rows(bank)
    if xp3.shape[-1] != M:
        raise ValueError(f"rows width {xp3.shape[-1]} != M {M}")
    lead, n_rows = xp3.shape[:-2], xp3.shape[-2]
    n_out = n_rows - R
    if n_out <= 0:
        raise ValueError(f"need more than R={R} rows, got {n_rows}")
    gs = jnp.asarray(stacked_bank_f32(bank))          # ((R+1)*L, M)
    pad = -n_rows % _ROW_BLOCK         # none for marshalled inputs
    if pad:
        xp3 = jnp.pad(xp3, [(0, 0)] * len(lead) + [(0, pad), (0, 0)])
    P = jnp.einsum("...qm,lm->...ql", xp3, gs, precision=precision)
    y = P[..., :n_out, :L]
    for r in range(1, R + 1):
        y = y + P[..., r : r + n_out, r * L : (r + 1) * L]
    return y


def resample_rows(x: jax.Array, bank: CycleBank,
                  out_len: int | None = None) -> tuple[jax.Array, int]:
    """Resample a flat ``(..., T)`` signal into cycle rows: returns
    ``(y (..., Q, L), out_len)`` where output sample ``t`` lives at
    ``y[..., t // L, t % L]`` and ``Q * L >= out_len``.

    Banks the rows form serves are zero-padded to ``n_rows * M`` samples
    (``n_rows >= Q + R``, whole ``_ROW_BLOCK``s), reshaped (row-major, a
    bitcast) to ``(n_rows, M)`` rows and evaluated by `resample_rows_pre`;
    the rest run the strided conv (or the banded form) and are padded to
    whole rows."""
    L, M = bank.L, bank.M
    T = x.shape[-1]
    if out_len is None:
        out_len = bank.out_len(T)
    lead = x.shape[:-1]
    if T == 0 or out_len == 0:
        return jnp.zeros((*lead, 0, L), dtype=x.dtype), out_len
    Q = -(-out_len // L)
    if not rows_pre_applicable(bank):
        y = resample(x, bank, out_len=out_len)
        y = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, Q * L - out_len)])
        return y.reshape(*lead, Q, L), out_len
    total = _rows_for_cycles(bank, Q) * M
    pf = bank.pad_front
    xp = jnp.pad(x, [(0, 0)] * len(lead) + [(pf, max(0, total - pf - T))])
    xp3 = xp[..., :total].reshape(*lead, total // M, M)
    return resample_rows_pre(xp3, bank)[..., :Q, :], out_len


def resample_auto(x: jax.Array, bank: CycleBank,
                  out_len: int | None = None) -> jax.Array:
    """`resample` with the per-bank choice of form: the rows GEMM
    (`resample_rows`) where `rows_pre_applicable`, the strided conv (or the
    banded form for varispeed banks) otherwise.  Returns ``(..., out_len)``."""
    if not rows_pre_applicable(bank):
        return resample(x, bank, out_len=out_len)
    y, out_len = resample_rows(x, bank, out_len=out_len)
    return y.reshape(*x.shape[:-1], -1)[..., :out_len]


@functools.partial(jax.jit, static_argnames=("rate_in", "rate_out", "quality", "kind", "out_len"))
def resample_rates(
    x: jax.Array,
    rate_in: int,
    rate_out: int,
    quality: str = "high",
    kind: str = "sinc",
    out_len: int | None = None,
) -> jax.Array:
    """Jitted convenience wrapper: design (host, cached) + resample (device)
    through `resample_auto`'s per-bank choice of form."""
    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    return resample_auto(x, bank, out_len=out_len)
