"""Pluggable on-device effect chain — the device-side *insert loop*.

The reference app's entire purpose is an insert loop: audio plays out through
external processors and is re-captured (claude.md:18;
Services/AudioProcessingService.swift:339-536).  The SRC graph replaces the
analog transport; a :class:`Chain` re-introduces the *processor*: a
user-supplied stack of in-graph stages applied to the resampled signal at the
output rate, before latency trimming.  A chain has real group delay and real
ring-out, which makes the surrounding machinery load-bearing exactly as in
the reference:

- calibration measures the chain's true delay with an impulse
  (Services/LatencyMeasurementService.swift:57-171),
- latency trim removes exactly that delay
  (AudioProcessingService.swift:681-703),
- capture head-room scales with the chain's ring-out up to the 60 s cap
  (Source/AppState.h:240-243; AudioProcessingService.swift:449-452),
- reverb-mode tails genuinely extend past the source and terminate at the
  noise floor (REVERB_MODE_IMPLEMENTATION.md:59-73).

Stages are built from host numpy data and embedded as XLA constants; a chain
is hashable by a content signature so it can ride through ``jax.jit`` as a
static argument (a changed IR is a changed chain — same invalidation
semantics as the reference's settings key,
Models/ProcessingSettings.swift:60-65).

Numerics: short FIR inserts evaluate as a position-invariant shifted-MAC
fold (`_fir_fold` — one fused elementwise pass whose per-element rounding is
independent of buffer offset, the property the byte-exact streaming
contract rides on); long convolutions (reverb IRs, long FIR/biquad IRs)
use uniform-partitioned overlap-save FFT convolution with a
frequency-domain delay line carried through ``lax.scan``, so memory stays
O(K·N) regardless of capture length.
"""

from __future__ import annotations

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Chain",
    "Gain",
    "Delay",
    "FIRInsert",
    "Biquad",
    "Saturator",
    "StereoWidth",
    "Compressor",
    "Expander",
    "Limiter",
    "ConvolutionReverb",
    "fft_convolve",
]


def _array_sig(a: np.ndarray) -> tuple:
    """Content signature of a host array: shape + 128-bit blake2b of the raw
    bytes.  Chains hash/compare by these signatures and ride ``jax.jit`` as
    static args — a 32-bit CRC's birthday odds (~1% at 10^4 distinct IRs in
    a long-lived service) would silently serve the WRONG chain's compiled
    graph, so the digest must be collision-free in practice."""
    a = np.ascontiguousarray(a)
    return (a.shape, hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest())


#: direct FIR-type stages (FIRInsert / Biquad truncated IRs) evaluate as the
#: position-invariant shifted-MAC fold up to this tap count; above it they
#: route to partitioned-FFT (UPOLS), whose batch and grid-keyed streaming
#: forms are byte-identical by construction.  The backend conv lowering is
#: NOT position/shape-invariant (XLA:CPU flips last-ulp ties on edge
#: columns, and other backends may pick another conv algorithm per shape),
#: so the byte-exact streaming contract cannot ride on `_direct_convolve`.
#: The fold emits ~2 HLO ops per tap (bounded trace), runs as one
#: fused pass, and its pairwise-tree association keeps rounding error
#: O(eps·log2 W) — measured at or below the conv's accuracy vs float64.
FIR_FOLD_MAX = 1024


def _fir_fold(x: jax.Array, taps: np.ndarray) -> jax.Array:
    """Causal direct FIR along the last axis with POSITION-INVARIANT
    numerics: ``out[n] = sum_k taps[k] * x[n-k]`` evaluated as ``W`` shifted
    scalar multiplies combined by a fixed pairwise tree, so every output
    element's float32 op sequence is independent of the array's length or
    offset (the property the chain's 0-ULP streaming contract rides on —
    same move as `_uniform_ma_past`, hardware-verified for dynamics in
    round 4 session 3c).  The tree association also bounds rounding at
    O(eps·log2 W) vs the sequential fold's O(eps·W)."""
    taps = np.asarray(taps, np.float32).reshape(-1)
    W = int(taps.shape[0])
    if W == 1:
        return x * taps[0]
    T = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(W - 1, 0)]
    xp = jnp.pad(x, pad)
    terms = [xp[..., W - 1 - k : W - 1 - k + T] * taps[k] for k in range(W)]
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _direct_convolve(x: jax.Array, taps: np.ndarray) -> jax.Array:
    """Causal direct-form convolution along the last axis, same length:
    ``out[n] = sum_k taps[k] * x[n-k]`` (XLA conv is correlation, so the taps
    are flipped; front padding keeps it causal)."""
    W = int(taps.shape[-1])
    lead, T = x.shape[:-1], x.shape[-1]
    xb = x.reshape(-1, 1, T)
    rhs = jnp.asarray(taps[::-1].copy(), jnp.float32).reshape(1, 1, W)
    y = jax.lax.conv_general_dilated(
        xb, rhs, window_strides=(1,), padding=((W - 1, 0),),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(*lead, T)


@functools.partial(jax.jit, static_argnames=("B",))
def _upols(xb: jax.Array, h_re: jax.Array, h_im: jax.Array, B: int) -> jax.Array:
    """Jitted uniform-partitioned overlap-save core: ``xb`` (R, T) real,
    ``h_re``/``h_im`` (K, N//2+1) the partitioned IR spectrum as split
    real/imag planes.  Complex values exist only as on-device intermediates:
    the whole pipeline runs under one jit with real-typed boundaries.
    """
    N = 2 * B
    Nf = N // 2 + 1
    R, T = xb.shape
    K = h_re.shape[0]
    H = jax.lax.complex(h_re, h_im)

    nb = max(1, -(-T // B))
    xp = jnp.pad(xb, ((0, 0), (0, nb * B - T)))
    blk = xp.reshape(R, nb, B)
    prev = jnp.pad(blk, ((0, 0), (1, 0), (0, 0)))[:, :nb]
    win = jnp.concatenate([prev, blk], axis=-1)              # (R, nb, N)

    def step(fdl, wi):                     # fdl (K, R, Nf); wi (R, N)
        Xi = jnp.fft.rfft(wi, n=N, axis=-1)
        fdl = jnp.concatenate([Xi[None], fdl[:-1]], axis=0)
        Y = jnp.sum(fdl * H[:, None, :], axis=0)
        yb = jnp.fft.irfft(Y, n=N, axis=-1)[:, B:]           # (R, B)
        return fdl, yb

    init = jnp.zeros((K, R, Nf), jnp.complex64)
    _, ys = jax.lax.scan(step, init, jnp.swapaxes(win, 0, 1))
    return jnp.swapaxes(ys, 0, 1).reshape(R, nb * B)[:, :T]


def _upols_stream(xb: jax.Array, prev_tail: jax.Array, fdl_re: jax.Array,
                  fdl_im: jax.Array, h_re, h_im, B: int):
    """Streaming twin of :func:`_upols`, BYTE-exact with it when the block
    grid is keyed to absolute stream positions: ``xb`` (R, T) with T a
    multiple of B and the chunk starting on a grid boundary; ``prev_tail``
    (R, B) the previous B input frames; ``fdl_re``/``fdl_im`` the carried
    frequency-domain delay line as split real/imag float32 planes (complex
    never crosses the jit boundary).
    Every per-block op (window assembly, rfft of an (R, 2B) row, the K-deep
    fdl multiply-sum, irfft) is IDENTICAL to the batch scan's step, and each
    block's window holds the same values, so the emitted floats match the
    whole-signal convolution bit for bit.  Returns (y, prev_tail', fdl')."""
    N = 2 * B
    R, T = xb.shape
    nb = T // B
    H = jax.lax.complex(h_re, h_im)
    blk = xb.reshape(R, nb, B)
    prevs = jnp.concatenate([prev_tail[:, None, :], blk[:, : nb - 1]], axis=1)
    win = jnp.concatenate([prevs, blk], axis=-1)             # (R, nb, N)

    def step(fdl, wi):                     # fdl (K, R, Nf); wi (R, N)
        Xi = jnp.fft.rfft(wi, n=N, axis=-1)
        fdl = jnp.concatenate([Xi[None], fdl[:-1]], axis=0)
        Y = jnp.sum(fdl * H[:, None, :], axis=0)
        yb = jnp.fft.irfft(Y, n=N, axis=-1)[:, B:]           # (R, B)
        return fdl, yb

    fdl0 = jax.lax.complex(fdl_re, fdl_im)
    fdl, ys = jax.lax.scan(step, fdl0, jnp.swapaxes(win, 0, 1))
    y = jnp.swapaxes(ys, 0, 1).reshape(R, nb * B)
    return y, xb[:, T - B:], jnp.real(fdl), jnp.imag(fdl)


def _fft_block_size(ir_len: int, block: int = 4096) -> int:
    """The B the UPOLS convolvers pick for this IR (must stay in lockstep
    with :func:`fft_convolve` / :func:`_fft_convolve_multi`): the streaming
    grid is a multiple of B, so chunk boundaries land on block boundaries."""
    B = int(block)
    while ir_len > 64 * B:
        B *= 2
    return B


def _ring_stream(stage, x: jax.Array, ring: jax.Array, rate: int):
    """Generic exact continuation for causal position-invariant stages: the
    stage's whole state is its last ``tail_frames`` of INPUT; prepend,
    apply, drop the context span (used by Chain.apply_stream for stages
    without their own state, and by the FIR-type stages' direct-conv
    paths)."""
    if ring.shape[-1] == 0:
        return stage.apply(x, rate), ring
    z = jnp.concatenate([ring, x], axis=-1)
    y = stage.apply(z, rate)[..., ring.shape[-1]:]
    return y, z[..., z.shape[-1] - ring.shape[-1]:]


def _partition_ir(ir: np.ndarray, B: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side IR partitioning: (K, N//2+1) float32 real/imag planes."""
    ir_len = int(ir.shape[0])
    N = 2 * B
    K = -(-ir_len // B)
    irp = np.pad(ir.astype(np.float64), (0, K * B - ir_len)).reshape(K, B)
    H = np.fft.rfft(irp, n=N, axis=-1)
    return (np.ascontiguousarray(H.real, np.float32),
            np.ascontiguousarray(H.imag, np.float32))


def fft_convolve(x: jax.Array, ir: np.ndarray, block: int = 4096) -> jax.Array:
    """Causal convolution of the last axis with a long IR, truncated to x's
    length (the capture window supplies tail room upstream).

    Uniform-partitioned overlap-save: the IR is split into K blocks of B,
    each input step FFTs one 2B window (hop B), and a K-deep frequency-domain
    delay line (the ``lax.scan`` carry) accumulates ``sum_k X[i-k] * H[k]``;
    the second half of each inverse FFT is alias-free output.  Work is
    O(T/B · K · N log N) and carry memory O(K·N) — independent of capture
    length, unlike a single whole-signal FFT.
    """
    ir = np.asarray(ir, np.float32).reshape(-1)
    ir_len = int(ir.shape[0])
    if ir_len == 0:
        return jnp.zeros_like(x)
    B = int(block)
    if B < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    while ir_len > 64 * B:  # bound the delay-line depth
        B *= 2
    h_re, h_im = _partition_ir(ir, B)
    lead, T = x.shape[:-1], x.shape[-1]
    y = _upols(x.reshape(-1, T), jnp.asarray(h_re), jnp.asarray(h_im), B)
    return y.reshape(*lead, T).astype(x.dtype)


def _fft_convolve_multi(x: jax.Array, irs: np.ndarray,
                        block: int = 4096) -> jax.Array:
    """Per-channel FFT convolution in ONE batched scan: ``x`` (..., C, T)
    with ``irs`` (C, ir_len) -> (..., C, T).  The per-channel partitioned
    spectra ride a leading ``vmap`` axis so all channels share one compiled
    scan — C separate :func:`fft_convolve` calls would launch C scans and
    re-FFT the input windows C times (the multichannel-reverb hot path)."""
    C, ir_len = irs.shape
    B = int(block)
    if B < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    while ir_len > 64 * B:
        B *= 2
    parts = [_partition_ir(np.asarray(irs[c], np.float32), B)
             for c in range(C)]
    h_re = jnp.asarray(np.stack([p[0] for p in parts]))
    h_im = jnp.asarray(np.stack([p[1] for p in parts]))
    lead, T = x.shape[:-2], x.shape[-1]
    xr = jnp.moveaxis(x, -2, 0).reshape(C, -1, T)
    y = jax.vmap(lambda xc, re, im: _upols(xc, re, im, B))(xr, h_re, h_im)
    y = jnp.moveaxis(y.reshape(C, *lead, T), 0, -2)
    return y.astype(x.dtype)


class Gain:
    """Scalar gain stage (an external processor's make-up gain)."""

    #: per-channel stage: safe to run inside a channel shard
    channel_local = True

    def __init__(self, db: float):
        self.db = float(db)

    def signature(self) -> tuple:
        return ("gain", round(self.db, 9))

    def tail_frames(self, rate: int) -> int:
        return 0

    def apply(self, y: jax.Array, rate: int) -> jax.Array:
        return y * np.float32(10.0 ** (self.db / 20.0))


class Delay:
    """Pure delay (models an external processor's transport latency — what
    the reference's round-trip calibration exists to measure)."""

    #: per-channel stage: safe to run inside a channel shard
    channel_local = True

    def __init__(self, seconds: float):
        if seconds < 0:
            raise ValueError("delay must be non-negative")
        self.seconds = float(seconds)

    def frames(self, rate: int) -> int:
        return int(round(self.seconds * rate))

    def signature(self) -> tuple:
        return ("delay", round(self.seconds, 9))

    def tail_frames(self, rate: int) -> int:
        return self.frames(rate)

    def apply(self, y: jax.Array, rate: int) -> jax.Array:
        d = self.frames(rate)
        if d == 0:
            return y
        T = y.shape[-1]
        pad = [(0, 0)] * (y.ndim - 1) + [(d, 0)]
        return jnp.pad(y, pad)[..., :T]


class FIRInsert:
    """A causal FIR processor (EQ / filter insert) with its *uncompensated*
    group delay — e.g. a linear-phase FIR delays by (W-1)/2 frames, which
    calibration must measure and trim (LATENCY_TRIMMING_FIX.md contract)."""

    #: per-channel stage: safe to run inside a channel shard
    channel_local = True

    def __init__(self, taps):
        self.taps = np.asarray(taps, np.float32).reshape(-1)
        if self.taps.size == 0:
            raise ValueError("FIR needs at least one tap")

    def signature(self) -> tuple:
        return ("fir", _array_sig(self.taps))

    def tail_frames(self, rate: int) -> int:
        return int(self.taps.shape[0]) - 1

    def apply(self, y: jax.Array, rate: int) -> jax.Array:
        if self.taps.shape[0] <= FIR_FOLD_MAX:
            return _fir_fold(y, self.taps)
        return fft_convolve(y, self.taps)

    # --- streaming: foldable taps ride the generic input ring (the fold is
    # position-invariant, so the ring continuation is byte-exact on every
    # backend); longer taps carry the UPOLS frequency-domain delay line on
    # the absolute block grid, byte-exact with the batch `fft_convolve` ---

    def stream_grid(self, rate: int) -> int:
        if self.taps.shape[0] <= FIR_FOLD_MAX:
            return 1
        return _fft_block_size(int(self.taps.shape[0]))

    def stream_state(self, rate: int, channels: int):
        if self.taps.shape[0] <= FIR_FOLD_MAX:
            return jnp.zeros((channels, self.tail_frames(rate)), jnp.float32)
        B = self.stream_grid(rate)
        K = -(-int(self.taps.shape[0]) // B)
        return (jnp.zeros((channels, B), jnp.float32),
                jnp.zeros((K, channels, B + 1), jnp.float32),
                jnp.zeros((K, channels, B + 1), jnp.float32))

    def apply_stream(self, x: jax.Array, state, rate: int, pos) -> tuple:
        if self.taps.shape[0] <= FIR_FOLD_MAX:
            return _ring_stream(self, x, state, rate)
        B = self.stream_grid(rate)
        h_re, h_im = _partition_ir(self.taps.astype(np.float32), B)
        prev, fre, fim = state
        y, prev, fre, fim = _upols_stream(x, prev, fre, fim,
                                          jnp.asarray(h_re),
                                          jnp.asarray(h_im), B)
        return y.astype(x.dtype), (prev, fre, fim)


class Biquad:
    """A second-order IIR EQ section (RBJ audio-EQ-cookbook forms), realised
    on device as a truncated impulse response driven through the same
    FIR machinery — a per-sample recurrence would serialise the device, while a
    stable biquad's IR decays geometrically, so truncating at the float32
    noise floor is exact to well below the -120 dB budget.

    The IR is sampled at chain-apply time for the *actual* session rate (the
    design is rate-dependent), so one Biquad object serves any output rate.
    """

    TYPES = ("lowpass", "highpass", "peaking", "lowshelf", "highshelf")

    #: per-channel stage: safe to run inside a channel shard
    channel_local = True

    def __init__(self, kind: str, freq_hz: float, q: float = 0.70710678,
                 gain_db: float = 0.0, max_ir_seconds: float = 2.0):
        if kind not in self.TYPES:
            raise ValueError(f"kind must be one of {self.TYPES}, got {kind!r}")
        if freq_hz <= 0 or q <= 0:
            raise ValueError("freq_hz and q must be positive")
        self.kind = kind
        self.freq_hz = float(freq_hz)
        self.q = float(q)
        self.gain_db = float(gain_db)
        self.max_ir_seconds = float(max_ir_seconds)
        self._ir_cache: dict[int, np.ndarray] = {}

    def signature(self) -> tuple:
        return ("biquad", self.kind, round(self.freq_hz, 6), round(self.q, 9),
                round(self.gain_db, 9), round(self.max_ir_seconds, 6))

    def coefficients(self, rate: int) -> tuple[np.ndarray, np.ndarray]:
        """Normalised (b, a) with a[0] == 1 (RBJ audio EQ cookbook)."""
        A = 10.0 ** (self.gain_db / 40.0)
        w0 = 2.0 * np.pi * min(self.freq_hz, 0.49 * rate) / rate
        cw, sw = np.cos(w0), np.sin(w0)
        alpha = sw / (2.0 * self.q)
        k = self.kind
        if k == "lowpass":
            b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
            a = np.array([1 + alpha, -2 * cw, 1 - alpha])
        elif k == "highpass":
            b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
            a = np.array([1 + alpha, -2 * cw, 1 - alpha])
        elif k == "peaking":
            b = np.array([1 + alpha * A, -2 * cw, 1 - alpha * A])
            a = np.array([1 + alpha / A, -2 * cw, 1 - alpha / A])
        elif k == "lowshelf":
            s = 2.0 * np.sqrt(A) * alpha
            b = A * np.array([(A + 1) - (A - 1) * cw + s,
                              2 * ((A - 1) - (A + 1) * cw),
                              (A + 1) - (A - 1) * cw - s])
            a = np.array([(A + 1) + (A - 1) * cw + s,
                          -2 * ((A - 1) + (A + 1) * cw),
                          (A + 1) + (A - 1) * cw - s])
        else:  # highshelf
            s = 2.0 * np.sqrt(A) * alpha
            b = A * np.array([(A + 1) + (A - 1) * cw + s,
                              -2 * ((A - 1) + (A + 1) * cw),
                              (A + 1) + (A - 1) * cw - s])
            a = np.array([(A + 1) - (A - 1) * cw + s,
                          2 * ((A - 1) - (A + 1) * cw),
                          (A + 1) - (A - 1) * cw - s])
        return (b / a[0]).astype(np.float64), (a / a[0]).astype(np.float64)

    def impulse_response(self, rate: int) -> np.ndarray:
        """float64 IR truncated where the remaining tail is below the float32
        quantum (geometric-decay bound from the pole radius)."""
        cached = self._ir_cache.get(rate)
        if cached is not None:
            return cached
        b, a = self.coefficients(rate)
        # size the render window from the POLE RADIUS: the envelope decays
        # ~ r^n, so reaching the 1e-10 (float32-quantum) threshold needs
        # n ~ log(1e-10)/log(r).  A high-Q low-frequency section can need
        # tens of seconds — max_ir_seconds is a floor for the window, not a
        # cap (a 2 s cap measured a -74 dB residual tail for a 40 Hz Q=30
        # peaking EQ at 96 kHz, far over the -120 dB budget).  The 64 s
        # hard bound only engages for pathological radii.
        r = min(0.999999, float(np.sqrt(max(a[2], 0.0))))
        need = (int(np.log(1e-10) / np.log(r)) + 16 if 0.0 < r < 1.0 else 16)
        n_max = max(16, int(self.max_ir_seconds * rate),
                    min(need, 64 * rate))
        # direct-form recursion in float64 (host, exact).  Truncation uses a
        # pole-radius envelope tracker, NOT consecutive small samples: a
        # high-Q low-frequency section's IR passes through zero every
        # half-period while its envelope is still large, and the old
        # two-small-samples test cut such tails at -69 dB (measured).
        try:
            from scipy.signal import lfilter

            imp = np.zeros(n_max)
            imp[0] = 1.0
            h = lfilter(b, a, imp)
            env = np.maximum.accumulate(np.abs(h)[::-1])[::-1]
            past = np.nonzero(env < 1e-10)[0]
            if past.size and past[0] > 8:
                h = h[: past[0] + 1]
        except ImportError:       # pragma: no cover - scipy is present here
            h = np.zeros(n_max)
            x1 = x2 = y1 = y2 = 0.0
            env = 0.0
            for n in range(n_max):
                xn = 1.0 if n == 0 else 0.0
                yn = b[0] * xn + b[1] * x1 + b[2] * x2 - a[1] * y1 - a[2] * y2
                h[n] = yn
                x2, x1 = x1, xn
                y2, y1 = y1, yn
                env = max(abs(yn), env * r)
                if n > 8 and env < 1e-10:
                    h = h[: n + 1]
                    break
        self._ir_cache[rate] = h
        return h

    def tail_frames(self, rate: int) -> int:
        return int(self.impulse_response(rate).shape[0]) - 1

    def apply(self, y: jax.Array, rate: int) -> jax.Array:
        h = self.impulse_response(rate).astype(np.float32)
        if h.shape[0] <= FIR_FOLD_MAX:
            return _fir_fold(y, h)
        return fft_convolve(y, h)

    # --- streaming: same dispatch as apply (fold ring / UPOLS state) ---

    def stream_grid(self, rate: int) -> int:
        n = int(self.impulse_response(rate).shape[0])
        return 1 if n <= FIR_FOLD_MAX else _fft_block_size(n)

    def stream_state(self, rate: int, channels: int):
        n = int(self.impulse_response(rate).shape[0])
        if n <= FIR_FOLD_MAX:
            return jnp.zeros((channels, n - 1), jnp.float32)
        B = _fft_block_size(n)
        K = -(-n // B)
        return (jnp.zeros((channels, B), jnp.float32),
                jnp.zeros((K, channels, B + 1), jnp.float32),
                jnp.zeros((K, channels, B + 1), jnp.float32))

    def apply_stream(self, x: jax.Array, state, rate: int, pos) -> tuple:
        h = self.impulse_response(rate).astype(np.float32)
        if h.shape[0] <= FIR_FOLD_MAX:
            return _ring_stream(self, x, state, rate)
        B = _fft_block_size(int(h.shape[0]))
        h_re, h_im = _partition_ir(h, B)
        prev, fre, fim = state
        y, prev, fre, fim = _upols_stream(x, prev, fre, fim,
                                          jnp.asarray(h_re),
                                          jnp.asarray(h_im), B)
        return y.astype(x.dtype), (prev, fre, fim)


class Saturator:
    """Memoryless waveshaper (the 'tape machine / tube stage in the loop'
    scenario — the most common outboard insert after EQ and compression).

    ``out = (1-mix)*y + mix * shape(drive*y) * 10^(trim_db/20)``.  At
    drive >= 0 dB every curve maps a full-scale input to full scale; at
    negative drive only ``tanh`` keeps that normalisation (``soft``/``hard``
    pass the attenuated signal through their linear region, i.e. a plain
    level drop — use ``trim_db`` to level-match wet/dry there):

    - ``tanh``:  tanh(g*x) / tanh(g)
    - ``soft``:  cubic soft clip 1.5u - 0.5u^3 on u = clip(g*x, -1, 1)
    - ``hard``:  clip(g*x, -1, 1)

    Zero latency and zero ring-out (tail_frames == 0); purely elementwise, so
    XLA fuses it into the surrounding graph for free.  Note the small-signal
    gain of the normalised curves exceeds unity as drive rises (g/tanh(g) for
    tanh) — use ``trim_db`` to compensate, as on the hardware.
    """

    KINDS = ("tanh", "soft", "hard")
    #: purely per-sample: safe under channel-axis sharding
    channel_local = True

    def __init__(self, kind: str = "tanh", drive_db: float = 0.0,
                 mix: float = 1.0, trim_db: float = 0.0):
        if kind not in self.KINDS:
            raise ValueError(f"kind must be one of {self.KINDS}, got {kind!r}")
        if not 0.0 <= mix <= 1.0:
            raise ValueError(f"mix must be in [0, 1], got {mix}")
        if not -100.0 <= drive_db <= 100.0:
            # beyond ~-700 dB the tanh normalisation's 1/tanh(g) overflows
            # float32 (and eventually divides by zero); +-100 dB covers any
            # physical drive with a huge margin
            raise ValueError(f"drive_db out of range [-100, 100]: {drive_db}")
        self.kind = kind
        self.drive_db = float(drive_db)
        self.mix = float(mix)
        self.trim_db = float(trim_db)

    def signature(self) -> tuple:
        return ("sat", self.kind, round(self.drive_db, 9),
                round(self.mix, 9), round(self.trim_db, 9))

    def tail_frames(self, rate: int) -> int:
        return 0

    def apply(self, y: jax.Array, rate: int) -> jax.Array:
        g = np.float32(10.0 ** (self.drive_db / 20.0))
        if self.kind == "tanh":
            # normalisation 1/tanh(g) in float64; for extreme negative drive
            # tanh(g) ~ g and the curve tends to identity (a hard max(g, eps)
            # clamp here would instead scale tiny-drive signals down)
            denom = float(np.tanh(np.float64(g))) or float(g)
            shaped = jnp.tanh(g * y) * np.float32(1.0 / denom)
        elif self.kind == "soft":
            u = jnp.clip(g * y, -1.0, 1.0)
            shaped = 1.5 * u - 0.5 * u * u * u
        else:  # hard
            shaped = jnp.clip(g * y, -1.0, 1.0)
        shaped = shaped * np.float32(10.0 ** (self.trim_db / 20.0))
        if self.mix >= 1.0:
            return shaped
        return np.float32(1.0 - self.mix) * y + np.float32(self.mix) * shaped


class StereoWidth:
    """Mid/side width control on a stereo pair: mid passes, side scales by
    ``width`` (0 = mono, 1 = unchanged, 2 = doubled side energy).  Requires
    exactly 2 channels on the signal's channel axis."""

    #: couples L/R: must see the whole pair (parallel/sharding.py gates
    #: channel-axis sharding on this flag)
    channel_local = False

    def __init__(self, width: float):
        if not 0.0 <= width <= 4.0:
            raise ValueError(f"width must be in [0, 4], got {width}")
        self.width = float(width)

    def signature(self) -> tuple:
        return ("width", round(self.width, 9))

    def tail_frames(self, rate: int) -> int:
        return 0

    def apply(self, y: jax.Array, rate: int) -> jax.Array:
        if y.ndim < 2:
            # a 1-D signal (the calibration impulse) is the correlated mid
            # path: side == 0, so width leaves it untouched — identity
            return y
        if y.shape[-2] != 2:
            raise ValueError(
                f"StereoWidth needs a stereo channel axis, got shape {y.shape}")
        l, r = y[..., 0, :], y[..., 1, :]
        m = 0.5 * (l + r)
        s = np.float32(0.5 * self.width) * (l - r)
        return jnp.stack([m + s, m - s], axis=-2)


class Compressor:
    """Feed-forward dynamics compressor, parallel on device: every stage is either a
    convolution or an (exactly) parallelised envelope — no per-sample serial
    recurrence anywhere.

    Detector: causal moving-RMS over ``detector_ms`` (FIR).  Channel-linked
    (max across the channel axis), like a stereo bus compressor.

    Envelope: instant attack, *linear-in-dB release* at ``release_db_per_s``:
    ``env[n] = max_k<=n (level_db[k] - c*(n-k))``.  That sliding slanted max
    equals ``cummax(level_db[k] + c*k) - c*n`` — an associative prefix max,
    which XLA computes in log depth; this is the classic analog "linear
    release" law, chosen precisely because it makes the recurrence
    associative on a parallel device.

    Gain computer: soft knee of ``knee_db`` around ``threshold_db`` with slope
    ``1 - 1/ratio``; the gain signal is then smoothed by a causal
    ``attack_ms`` moving average (a lookahead-free attack ramp).  Gain is
    applied sample-aligned, so the stage adds **zero signal latency**; its
    influence horizon (for streaming continuation) is the release run-length
    of the full dynamic range plus the detector/attack windows.
    """

    #: the stereo/bus link couples channels: must see them all
    #: (parallel/sharding.py gates channel-axis sharding on this flag)
    channel_local = False

    def __init__(self, threshold_db: float = -24.0, ratio: float = 4.0,
                 attack_ms: float = 5.0, release_db_per_s: float = 80.0,
                 knee_db: float = 6.0, makeup_db: float = 0.0,
                 detector_ms: float = 1.0):
        if ratio < 1.0:
            raise ValueError(f"ratio must be >= 1, got {ratio}")
        if release_db_per_s <= 0:
            raise ValueError("release_db_per_s must be positive")
        if attack_ms < 0 or detector_ms < 0 or knee_db < 0:
            raise ValueError("attack_ms/detector_ms/knee_db must be >= 0")
        self.threshold_db = float(threshold_db)
        self.ratio = float(ratio)
        self.attack_ms = float(attack_ms)
        self.release_db_per_s = float(release_db_per_s)
        self.knee_db = float(knee_db)
        self.makeup_db = float(makeup_db)
        self.detector_ms = float(detector_ms)

    def signature(self) -> tuple:
        return ("comp", round(self.threshold_db, 9), round(self.ratio, 9),
                round(self.attack_ms, 9), round(self.release_db_per_s, 9),
                round(self.knee_db, 9), round(self.makeup_db, 9),
                round(self.detector_ms, 9))

    def tail_frames(self, rate: int) -> int:
        # release horizon: frames for 120 dB of gain recovery (beyond which
        # the envelope's influence is under any audible/quantisable floor)
        horizon = int(np.ceil(120.0 / self.release_db_per_s * rate))
        win_det = max(1, int(round(self.detector_ms * rate / 1000.0)))
        win_att = max(1, int(round(self.attack_ms * rate / 1000.0)))
        return horizon + win_det + win_att

    #: block length for the slanted cummax: c*B stays ~1e2 so float32 keeps
    #: ~1e-5 dB envelope resolution for ANY file length (a single global
    #: c*n ramp loses integer spacing past 2^24 frames).  The streaming form
    #: (`_slanted_cummax_stream`) keys its blocks to ABSOLUTE positions on
    #: this same grid, which is what makes stream-vs-batch byte-exact.
    _ENV_BLOCK = 1 << 17

    @staticmethod
    def _slanted_cummax(level_db: jax.Array, c: float) -> jax.Array:
        """``env[n] = max_{k<=n}(level[k] - c*(n-k))`` exactly, any length:
        per-block rebased ramps + a scanned cross-block carry (still log
        depth within blocks; the scan is over T/2^17 blocks)."""
        T = level_db.shape[-1]
        B = Compressor._ENV_BLOCK
        c = np.float32(c)
        if T <= B:
            n = jnp.arange(T, dtype=jnp.float32)
            return jax.lax.cummax(level_db + c * n,
                                  axis=level_db.ndim - 1) - c * n
        lead = level_db.shape[:-1]
        nb = -(-T // B)
        lv = jnp.pad(level_db,
                     [(0, 0)] * (level_db.ndim - 1) + [(0, nb * B - T)],
                     constant_values=-1e9)
        blocks = jnp.moveaxis(lv.reshape(*lead, nb, B), -2, 0)
        ramp = jnp.arange(B, dtype=jnp.float32) * c
        decay = c * (jnp.arange(B, dtype=jnp.float32) + 1.0)

        def step(carry, blk):
            slant = jax.lax.cummax(blk + ramp, axis=blk.ndim - 1) - ramp
            env = jnp.maximum(slant, carry[..., None] - decay)
            return env[..., -1], env

        carry0 = jnp.full(lead, -1e9, jnp.float32)
        _, envs = jax.lax.scan(step, carry0, blocks)
        return jnp.moveaxis(envs, 0, -2).reshape(*lead, nb * B)[..., :T]

    @staticmethod
    def _slanted_cummax_stream(level_db: jax.Array, c: float, pos: jax.Array,
                               m: jax.Array, env_carry: jax.Array):
        """Streaming form of :meth:`_slanted_cummax`, BYTE-exact with it:
        blocks are keyed to the ABSOLUTE output position grid (multiples of
        ``_ENV_BLOCK`` from stream position 0 — the same grid the batch form
        tiles), so every in-block ``level + c*j`` add and every cross-block
        ``carry - c*B`` subtract rounds identically.  The carried state per
        linked lane is ``m`` (the running in-block max of ``level + ramp``
        over the current partial block) and ``env_carry`` (the cross-block
        carry entering that block) — exactly what the batch scan computes at
        the chunk boundary.  ``pos`` is a traced int32 (per-chunk positions
        never recompile); block alignment is handled by placing the chunk
        into a grid-aligned buffer at ``pos % B`` (max is exact/associative,
        so the -1e9 padding and the seed-max injection are bit-neutral)."""
        c = np.float32(c)
        B = Compressor._ENV_BLOCK
        T = level_db.shape[-1]
        lead = level_db.shape[:-1]
        nb = (T + B - 1) // B + 1          # worst-case grid straddle
        o = pos % B
        zeros = (0,) * len(lead)
        buf = jnp.full((*lead, nb * B), -1e9, jnp.float32)
        buf = jax.lax.dynamic_update_slice(buf, level_db, zeros + (o,))
        blocks = jnp.moveaxis(buf.reshape(*lead, nb, B), -2, 0)
        ramp = jnp.arange(B, dtype=jnp.float32) * c
        decay = c * (jnp.arange(B, dtype=jnp.float32) + 1.0)
        seeds = jnp.concatenate(
            [m[None], jnp.full((nb - 1, *lead), -1e9, jnp.float32)], axis=0)

        def step(carry, inp):
            blk, seed = inp
            s = jnp.maximum(jax.lax.cummax(blk + ramp, axis=blk.ndim - 1),
                            seed[..., None])
            slant = s - ramp
            env = jnp.maximum(slant, carry[..., None] - decay)
            return env[..., -1], (env, s)

        _, (envs, ss) = jax.lax.scan(step, env_carry, (blocks, seeds))
        env_flat = jnp.moveaxis(envs, 0, -2).reshape(*lead, nb * B)
        s_flat = jnp.moveaxis(ss, 0, -2).reshape(*lead, nb * B)
        env_out = jax.lax.dynamic_slice(env_flat, zeros + (o,), (*lead, T))
        # next-chunk state: m resumes the partial block containing pos+T
        # (fresh -1e9 when the chunk ends exactly on the grid), and the
        # cross-block carry advances past the blocks the chunk completed
        pos2 = pos + T
        m_next = jnp.where(
            pos2 % B == 0, jnp.float32(-1e9),
            jax.lax.dynamic_slice(s_flat, zeros + (o + T - 1,),
                                  (*lead, 1))[..., 0])
        b_rel = pos2 // B - pos // B
        carr_stack = envs[..., -1]                       # (nb, *lead)
        carry_next = jnp.where(
            b_rel == 0, env_carry,
            jnp.take(carr_stack, jnp.clip(b_rel - 1, 0, nb - 1), axis=0))
        return env_out, m_next, carry_next

    def _gr_from_env(self, env_db: jax.Array) -> jax.Array:
        """Unsmoothed gain reduction (dB, <= 0) from the envelope: soft-knee
        gain computer shared verbatim by the batch and streaming paths."""
        over = env_db - np.float32(self.threshold_db)
        slope = np.float32(1.0 - 1.0 / self.ratio)
        if self.knee_db > 0:
            k2 = np.float32(self.knee_db / 2.0)
            knee_gr = -slope * jnp.square(over + k2) / np.float32(
                2.0 * self.knee_db)
            return jnp.where(over <= -k2, 0.0,
                             jnp.where(over >= k2, -slope * over, knee_gr))
        return jnp.minimum(0.0, -slope * over)

    def _gain_db(self, y: jax.Array, rate: int) -> jax.Array:
        # moving averages via the position-invariant fold (`_uniform_ma_past`)
        # — the streamed form must round identically per sample on every
        # backend, which the conv lowering does not guarantee
        win = max(1, int(round(self.detector_ms * rate / 1000.0)))
        p = _uniform_ma_past(jnp.square(y), win)
        if y.ndim >= 2:
            p = jnp.max(p, axis=-2, keepdims=True)       # stereo/bus link
        level_db = 10.0 * jnp.log10(jnp.maximum(p, 1e-20))
        env_db = self._slanted_cummax(level_db, self.release_db_per_s / rate)
        gr = self._gr_from_env(env_db)
        win_a = max(1, int(round(self.attack_ms * rate / 1000.0)))
        if win_a > 1:
            gr = _uniform_ma_past(gr, win_a)
        return gr + np.float32(self.makeup_db)

    def apply(self, y: jax.Array, rate: int) -> jax.Array:
        gain = 10.0 ** (self._gain_db(y, rate) * np.float32(1.0 / 20.0))
        return y * gain

    def stream_state(self, rate: int, channels: int) -> tuple:
        """Initial streaming state: (detector input tail, unsmoothed-gr tail,
        in-block running max, cross-block env carry).  The zero tails
        reproduce the batch convolutions' front zero-padding at stream start;
        -1e9 is the batch scan's virgin carry."""
        win = max(1, int(round(self.detector_ms * rate / 1000.0)))
        win_a = max(1, int(round(self.attack_ms * rate / 1000.0)))
        return (jnp.zeros((channels, win - 1), jnp.float32),
                jnp.zeros((1, win_a - 1), jnp.float32),
                jnp.full((1,), -1e9, jnp.float32),
                jnp.full((1,), -1e9, jnp.float32))

    def apply_stream(self, y: jax.Array, state: tuple, rate: int,
                     pos: jax.Array) -> tuple:
        """Chunked application, BYTE-exact with :meth:`apply` over the whole
        stream: the detector and attack moving averages carry their input
        tails (XLA convs are position-invariant bitwise — same window, same
        dot), and the release envelope carries the slanted-cummax scan state
        on the absolute block grid (`_slanted_cummax_stream`).  ``pos`` is
        the chunk's absolute start position in the chain-input stream."""
        x_tail, gr_tail, m, env_carry = state
        win = max(1, int(round(self.detector_ms * rate / 1000.0)))
        xin = (jnp.concatenate([x_tail, y], axis=-1) if win > 1 else y)
        p = _uniform_ma_past(jnp.square(xin), win)
        p = p[..., xin.shape[-1] - y.shape[-1]:]
        if y.ndim >= 2:
            p = jnp.max(p, axis=-2, keepdims=True)       # stereo/bus link
        level_db = 10.0 * jnp.log10(jnp.maximum(p, 1e-20))
        env_db, m, env_carry = self._slanted_cummax_stream(
            level_db, self.release_db_per_s / rate, pos, m, env_carry)
        gr = self._gr_from_env(env_db)
        win_a = max(1, int(round(self.attack_ms * rate / 1000.0)))
        if win_a > 1:
            gc = jnp.concatenate([gr_tail, gr], axis=-1)
            sm = _uniform_ma_past(gc, win_a)
            sm = sm[..., gc.shape[-1] - gr.shape[-1]:]
            gr_tail = gc[..., gc.shape[-1] - (win_a - 1):]
            gr = sm
        gain = 10.0 ** ((gr + np.float32(self.makeup_db))
                        * np.float32(1.0 / 20.0))
        if win > 1:
            x_tail = xin[..., xin.shape[-1] - (win - 1):]
        return y * gain, (x_tail, gr_tail, m, env_carry)


#: `_uniform_ma_past` falls back to the conv above this window (a Python
#: fold emits one HLO add per tap; thousands would bloat the trace).  8 ms
#: at 192 kHz is 1536 taps, so every practical dynamics window folds.
_MA_FOLD_MAX = 4096


def _uniform_ma_past(x: jax.Array, win: int) -> jax.Array:
    """Causal uniform moving average with POSITION-INVARIANT numerics:
    ``out[n] = (sum_{k<win} x[n-k]) / win`` evaluated as an explicit
    fixed-order fold of ``win`` shifted copies, so every output element's
    float32 op sequence is independent of the array's length or offset.

    A backend conv lowering does NOT guarantee that: the same window
    summed as a conv column can round differently depending on the spatial
    extent and the column's position in it (measured: last-ulp flips on
    XLA:CPU edge columns; other backends may pick another algorithm per
    shape).  The dynamics
    stages' byte-exact streaming contract (chunked == whole at 0 ULP on
    EVERY backend) therefore rides on this fold, not on the conv.  Windows
    beyond `_MA_FOLD_MAX` taps fall back to the conv (no practical
    dynamics window reaches that; the fallback trades bitwise chunk
    invariance for trace size)."""
    if win <= 1:
        return x
    if win > _MA_FOLD_MAX:
        return _direct_convolve(x, np.full(win, 1.0 / win, np.float32))
    pad = [(0, 0)] * (x.ndim - 1) + [(win - 1, 0)]
    xp = jnp.pad(x, pad)
    T = x.shape[-1]
    acc = xp[..., win - 1 : win - 1 + T]
    for k in range(1, win):
        acc = acc + xp[..., win - 1 - k : win - 1 - k + T]
    return acc * np.float32(1.0 / win)


def _window_max_past(a: jax.Array, W: int) -> jax.Array:
    """Causal windowed maximum over the last axis: ``out[m] = max a[m-W+1..m]``
    (positions before the start read as 0 — callers feed non-negative
    attenuation streams, for which 0 is the neutral element).  Log-depth
    sparse-table doubling: ~log2(W) shifted maxima instead of W; max is
    exact and associative, so the result is bitwise the window max
    regardless of the combine order (which is what makes the streaming
    recomputation over a context ring byte-identical)."""
    if W <= 1:
        return a
    pad_cfg = [(0, 0)] * (a.ndim - 1)
    f, s = a, 1
    while s * 2 <= W:
        f = jnp.maximum(f, jnp.pad(f, pad_cfg + [(s, 0)])[..., : a.shape[-1]])
        s *= 2
    rem = W - s
    if rem:
        f = jnp.maximum(f, jnp.pad(f, pad_cfg + [(rem, 0)])[..., : a.shape[-1]])
    return f


class Expander(Compressor):
    """Downward expander / noise gate (the 'gate in the loop' scenario —
    the other half of the outboard dynamics rack).  Shares the Compressor's
    parallel machinery wholesale: moving-RMS detector, channel link,
    slanted-cummax release envelope (which doubles as the gate's HOLD — a
    transient keeps the gate open while the envelope decays at
    ``release_db_per_s``), and the causal attack smoother.  Only the gain
    computer differs: below ``threshold_db`` the gain falls at
    ``(ratio - 1)`` dB per dB of shortfall, floored at ``-range_db`` (a
    gate is an expander with a high ratio).  Streaming is byte-exact via
    the inherited stateful `apply_stream`.

    ``attack_ms`` defaults to 0 (instant open — the usual gate behaviour):
    a nonzero attack averages the gain over its window, so a transient
    arriving while the gate is closed is partially chopped (as on hardware
    gates) — including the calibration impulse, which a slow-attack gate
    can suppress below the detection threshold (supply
    ``cfg.latency_frames`` explicitly in that case)."""

    def __init__(self, threshold_db: float = -50.0, ratio: float = 2.0,
                 attack_ms: float = 0.0, release_db_per_s: float = 200.0,
                 range_db: float = 60.0, makeup_db: float = 0.0,
                 detector_ms: float = 5.0):
        if range_db <= 0:
            raise ValueError(f"range_db must be positive, got {range_db}")
        super().__init__(threshold_db=threshold_db, ratio=ratio,
                         attack_ms=attack_ms,
                         release_db_per_s=release_db_per_s, knee_db=0.0,
                         makeup_db=makeup_db, detector_ms=detector_ms)
        self.range_db = float(range_db)

    def signature(self) -> tuple:
        return ("expand", round(self.threshold_db, 9), round(self.ratio, 9),
                round(self.attack_ms, 9), round(self.release_db_per_s, 9),
                round(self.range_db, 9), round(self.makeup_db, 9),
                round(self.detector_ms, 9))

    def tail_frames(self, rate: int) -> int:
        # the envelope's influence reaches until a past transient has
        # decayed past the threshold by the full range (beyond which the
        # gate floor is saturated): range + 120 dB covers any audible case
        horizon = int(np.ceil((120.0 + self.range_db)
                              / self.release_db_per_s * rate))
        win_det = max(1, int(round(self.detector_ms * rate / 1000.0)))
        win_att = max(1, int(round(self.attack_ms * rate / 1000.0)))
        return horizon + win_det + win_att

    def _gr_from_env(self, env_db: jax.Array) -> jax.Array:
        under = jnp.minimum(0.0, env_db - np.float32(self.threshold_db))
        return jnp.clip(under * np.float32(self.ratio - 1.0),
                        -np.float32(self.range_db), 0.0)


class Limiter:
    """Lookahead brickwall limiter, parallel on device: every stage is an
    associative scan or a small windowed reduction — no serial recurrence.

    The signal is delayed by ``lookahead_ms``; the gain is computed from the
    UNdelayed channel-linked peak, so attenuation ramps in before a peak
    arrives and the ceiling is guaranteed (in exact arithmetic; float
    rounding can poke ~1 ULP above):

    - ``atten[m] = max(0, level_db[m] - ceiling_db)`` — needed attenuation,
    - release: ``atten_rel = slanted_cummax(atten, release_db_per_s)`` (the
      Compressor's associative linear-dB law; attack is instant here),
    - lookahead spread: ``B[m] = max(atten_rel[m-L..m])`` (windowed max),
    - ramp: ``S[m] = mean(B[m-L..m])`` (the moving average turns the
      rectangular dip into a linear ramp reaching full attenuation exactly
      when the peak plays),
    - ``out[n] = x[n-L] * 10^(-S[n]/20)``.

    The brickwall guarantee: every ``B[n-i]`` window (i in [0, L]) contains
    position ``n-L``, so ``S[n] >= atten_rel[n-L] >= atten[n-L]`` and the
    played sample never exceeds the ceiling.  The ``L``-frame delay is real
    group delay — calibration measures it and latency trim removes it, the
    framework's apply-what-you-measure contract.

    The ceiling holds at the LIMITER's output; the batch graph's later
    stages can shift the final peak slightly — DC removal subtracts the
    whole-capture mean after the chain (the reference's capture-then-
    DC-remove order, Source/MainComponent.cpp:751-805; ~0.01 dB on noisy
    programme), and ``gain_db``/normalization scale it outright.  For a
    strict deliverable ceiling, disable ``remove_dc`` or leave headroom."""

    #: linked across channels (like the stereo bus limiter it models)
    channel_local = False

    def __init__(self, ceiling_db: float = -0.3, lookahead_ms: float = 1.5,
                 release_db_per_s: float = 300.0):
        if not -60.0 <= ceiling_db <= 0.0:
            raise ValueError(f"ceiling_db out of range [-60, 0]: {ceiling_db}")
        if lookahead_ms <= 0:
            raise ValueError("lookahead_ms must be positive")
        if release_db_per_s <= 0:
            raise ValueError("release_db_per_s must be positive")
        self.ceiling_db = float(ceiling_db)
        self.lookahead_ms = float(lookahead_ms)
        self.release_db_per_s = float(release_db_per_s)

    def signature(self) -> tuple:
        return ("limit", round(self.ceiling_db, 9),
                round(self.lookahead_ms, 9),
                round(self.release_db_per_s, 9))

    def lookahead_frames(self, rate: int) -> int:
        return max(1, int(round(self.lookahead_ms * rate / 1000.0)))

    def tail_frames(self, rate: int) -> int:
        L = self.lookahead_frames(rate)
        horizon = int(np.ceil(120.0 / self.release_db_per_s * rate))
        return 3 * L + horizon

    def _atten_db(self, x: jax.Array, rate: int) -> jax.Array:
        """The smoothed attenuation stream S (dB >= 0), channel-linked."""
        L = self.lookahead_frames(rate)
        if x.ndim >= 2:
            lvl = jnp.max(jnp.abs(x), axis=-2, keepdims=True)
        else:
            lvl = jnp.abs(x)
        level_db = 20.0 * jnp.log10(jnp.maximum(lvl, 1e-20))
        atten = jnp.maximum(0.0, level_db - np.float32(self.ceiling_db))
        atten_rel = Compressor._slanted_cummax(
            atten, self.release_db_per_s / rate)
        b = _window_max_past(atten_rel, L + 1)
        return _uniform_ma_past(b, L + 1)

    def apply(self, x: jax.Array, rate: int) -> jax.Array:
        L = self.lookahead_frames(rate)
        s_db = self._atten_db(x, rate)
        pad = [(0, 0)] * (x.ndim - 1) + [(L, 0)]
        xd = jnp.pad(x, pad)[..., : x.shape[-1]]
        return xd * 10.0 ** (s_db * np.float32(-1.0 / 20.0))

    # --- byte-exact streaming: the delay/window rings carry raw inputs and
    # intermediate attenuation values; the release envelope carries the
    # slanted-cummax scan state on the absolute block grid ---

    def stream_state(self, rate: int, channels: int) -> tuple:
        L = self.lookahead_frames(rate)
        return (jnp.zeros((channels, L), jnp.float32),   # signal delay ring
                jnp.zeros((1, L), jnp.float32),          # atten_rel ring (B)
                jnp.zeros((1, L), jnp.float32),          # B ring (S average)
                jnp.full((1,), -1e9, jnp.float32),       # in-block run max
                jnp.full((1,), -1e9, jnp.float32))       # cross-block carry

    def apply_stream(self, x: jax.Array, state: tuple, rate: int,
                     pos: jax.Array) -> tuple:
        L = self.lookahead_frames(rate)
        x_tail, ar_tail, b_tail, m, env_carry = state
        if x.ndim >= 2:
            lvl = jnp.max(jnp.abs(x), axis=-2, keepdims=True)
        else:
            lvl = jnp.abs(x)
        level_db = 20.0 * jnp.log10(jnp.maximum(lvl, 1e-20))
        atten = jnp.maximum(0.0, level_db - np.float32(self.ceiling_db))
        atten_rel, m, env_carry = Compressor._slanted_cummax_stream(
            atten, self.release_db_per_s / rate, pos, m, env_carry)
        ac = jnp.concatenate([ar_tail, atten_rel], axis=-1)
        b = _window_max_past(ac, L + 1)[..., L:]
        bc = jnp.concatenate([b_tail, b], axis=-1)
        s_db = _uniform_ma_past(bc, L + 1)[..., L:]
        xc = jnp.concatenate([x_tail, x], axis=-1)
        xd = xc[..., : x.shape[-1]]
        out = xd * 10.0 ** (s_db * np.float32(-1.0 / 20.0))
        return out, (xc[..., xc.shape[-1] - L:],
                     ac[..., ac.shape[-1] - L:],
                     bc[..., bc.shape[-1] - L:], m, env_carry)


class ConvolutionReverb:
    """Convolution with a measured impulse response (the 'reverb unit in the
    loop' scenario, REVERB_MODE_IMPLEMENTATION.md): ``out = dry*y + wet*(y*ir)``.

    ``ir``: (ir_len,) mono (shared across channels) or (channels, ir_len)
    true-stereo/multichannel, matched positionally to the signal's channels.
    """

    #: per-channel stage: safe to run inside a channel shard
    channel_local = True

    def __init__(self, ir, wet: float = 1.0, dry: float = 0.0):
        ir = np.asarray(ir, np.float32)
        if ir.ndim == 1:
            ir = ir[None]
        if ir.ndim != 2 or ir.shape[-1] == 0:
            raise ValueError("ir must be (ir_len,) or (channels, ir_len)")
        self.ir = ir
        self.wet = float(wet)
        self.dry = float(dry)

    def signature(self) -> tuple:
        return ("convreverb", _array_sig(self.ir),
                round(self.wet, 9), round(self.dry, 9))

    def tail_frames(self, rate: int) -> int:
        return int(self.ir.shape[-1]) - 1

    def apply(self, y: jax.Array, rate: int) -> jax.Array:
        n_ir = self.ir.shape[0]
        if n_ir == 1:
            wet = fft_convolve(y, self.ir[0])
        elif y.ndim < 2:
            # the 1-D calibration impulse: measure through the FIRST IR
            # channel (group delay is per-unit, not per-channel; without
            # this, a true-stereo IR crashed the whole batch in calibration)
            wet = fft_convolve(y, self.ir[0])
        else:
            if y.shape[-2] != n_ir:
                raise ValueError(
                    f"multichannel IR has {n_ir} channels but the signal's "
                    f"channel axis is {y.shape[-2]}")
            wet = _fft_convolve_multi(y, self.ir)
        out = np.float32(self.wet) * wet
        if self.dry:
            out = out + np.float32(self.dry) * y
        return out

    # --- streaming: UPOLS state on the absolute block grid (round 4).
    # Chunked output is byte-exact with the whole-stream apply — the last
    # byte-identity exception closed (chunk boundaries land on FFT block
    # boundaries; Chain.stream_grid sizes the stream's chunks) ---

    def stream_grid(self, rate: int) -> int:
        return _fft_block_size(int(self.ir.shape[-1]))

    def stream_state(self, rate: int, channels: int):
        B = self.stream_grid(rate)
        K = -(-int(self.ir.shape[-1]) // B)
        if self.ir.shape[0] == 1:
            return (jnp.zeros((channels, B), jnp.float32),
                    jnp.zeros((K, channels, B + 1), jnp.float32),
                    jnp.zeros((K, channels, B + 1), jnp.float32))
        # true-stereo/multichannel: per-channel delay lines on a leading
        # vmap axis, exactly like `_fft_convolve_multi`'s layout
        C = int(self.ir.shape[0])
        return (jnp.zeros((C, 1, B), jnp.float32),
                jnp.zeros((C, K, 1, B + 1), jnp.float32),
                jnp.zeros((C, K, 1, B + 1), jnp.float32))

    def apply_stream(self, x: jax.Array, state, rate: int, pos) -> tuple:
        B = self.stream_grid(rate)
        prev, fre, fim = state
        if self.ir.shape[0] == 1:
            h_re, h_im = _partition_ir(
                np.asarray(self.ir[0], np.float32), B)
            wet, prev, fre, fim = _upols_stream(
                x, prev, fre, fim, jnp.asarray(h_re), jnp.asarray(h_im), B)
        else:
            C = int(self.ir.shape[0])
            if x.shape[-2] != C:
                raise ValueError(
                    f"multichannel IR has {C} channels but the signal's "
                    f"channel axis is {x.shape[-2]}")
            parts = [_partition_ir(np.asarray(self.ir[c], np.float32), B)
                     for c in range(C)]
            h_re = jnp.asarray(np.stack([p[0] for p in parts]))
            h_im = jnp.asarray(np.stack([p[1] for p in parts]))
            xr = x[:, None, :]                    # (C, 1, T) like the batch
            wet, prev, fre, fim = jax.vmap(
                lambda xc, pt, fr, fi, re, im:
                    _upols_stream(xc, pt, fr, fi, re, im, B)
            )(xr, prev, fre, fim, h_re, h_im)
            wet = wet[:, 0, :]
        wet = wet.astype(x.dtype)
        out = np.float32(self.wet) * wet
        if self.dry:
            out = out + np.float32(self.dry) * x
        return out, (prev, fre, fim)


class Chain:
    """An ordered stack of stages, hashable by content so it can be a
    ``jax.jit`` static argument and a calibration-cache key component."""

    def __init__(self, *stages):
        for s in stages:
            for attr in ("signature", "tail_frames", "apply"):
                if not callable(getattr(s, attr, None)):
                    raise TypeError(
                        f"stage {s!r} lacks required method {attr}()")
        self.stages = tuple(stages)
        self._sig = tuple(s.signature() for s in self.stages)

    def signature(self) -> tuple:
        return self._sig

    def sig_str(self) -> str:
        """Compact signature for persistent cache keys (collision-free
        digest: a colliding key would reuse another chain's measured
        latency)."""
        return hashlib.blake2b(repr(self._sig).encode(),
                               digest_size=16).hexdigest()

    def tail_frames(self, rate: int) -> int:
        """Worst-case ring-out of the whole chain at ``rate`` (delays and
        convolution tails accumulate through the stack)."""
        return sum(s.tail_frames(rate) for s in self.stages)

    def apply(self, y: jax.Array, rate: int) -> jax.Array:
        for s in self.stages:
            y = s.apply(y, rate)
        # Pin the chain's output as one materialisation: the batch graph's
        # downstream stages are fused consumers that recompute their producer
        # (pipeline/graph.py), and without a barrier XLA may duplicate the
        # chain's convolutions into each of them — same discipline as the SRC
        # output barrier.
        return jax.lax.optimization_barrier(y)

    def stream_grid(self, rate: int) -> int:
        """Chunk-length granule for exact streaming: the lcm of every
        stage's UPOLS block size (1 when no stage convolves by FFT).  The
        streaming pipeline sizes its chunks to a multiple of this so chunk
        boundaries land on FFT block boundaries — the condition under which
        `apply_stream` is byte-exact for FFT stages too."""
        import math

        g = 1
        for s in self.stages:
            sg = int(getattr(s, "stream_grid", lambda _r: 1)(rate))
            g = g * sg // math.gcd(g, sg)
        return g

    def stream_init(self, rate: int, channels: int) -> tuple:
        """Initial per-stage streaming state (a jit-traceable pytree).
        Stages that implement ``stream_state``/``apply_stream`` own their
        state (Compressor: envelope scan state; FFT convolvers: the UPOLS
        frequency-domain delay line + previous input block); every other
        stage gets a zero input-context ring of its own ``tail_frames``
        (the whole state of a causal FIR/delay stage), or ``None`` for
        memoryless stages."""
        states = []
        for s in self.stages:
            if hasattr(s, "apply_stream"):
                states.append(s.stream_state(rate, channels))
            else:
                t = int(s.tail_frames(rate))
                states.append(jnp.zeros((channels, t), jnp.float32)
                              if t else None)
        return tuple(states)

    def apply_stream(self, y: jax.Array, states: tuple, rate: int,
                     pos: jax.Array) -> tuple:
        """Apply the chain to one streamed chunk with exact continuation:
        each stage threads its own state, so the emitted chunk equals the
        corresponding span of the whole-stream :meth:`apply` BYTE-exactly —
        delays, FIRs (shifted-MAC fold and partitioned-FFT), biquad IRs,
        reverb IRs and dynamics alike, on every backend (the fold and the
        grid-keyed UPOLS are position-invariant; the backend conv the
        FIR-type stages previously streamed through is not).  Contract: when
        `stream_grid(rate)` > 1, every chunk's length (and therefore ``pos``) must be a multiple of it, so
        the UPOLS block grid stays keyed to absolute stream positions (the
        streaming pipeline's chunk sizing guarantees this).  ``pos`` is the
        chunk's absolute start in the chain-input stream (stages are
        same-length maps, so one position serves every stage)."""
        new = []
        for s, st in zip(self.stages, states):
            if hasattr(s, "apply_stream"):
                y, st = s.apply_stream(y, st, rate, pos)
            elif st is not None:
                y, st = _ring_stream(s, y, st, rate)
            else:
                y = s.apply(y, rate)
            new.append(st)
        return jax.lax.optimization_barrier(y), tuple(new)

    def __hash__(self):
        return hash(self._sig)

    def __eq__(self, other):
        return isinstance(other, Chain) and self._sig == other._sig

    def __repr__(self):
        return f"Chain({', '.join(type(s).__name__ for s in self.stages)})"
