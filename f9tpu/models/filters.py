"""Polyphase filter-bank design for rational sample-rate conversion.

This is the on-device replacement for the DSP the reference app delegates to
JUCE's ``WindowedSincInterpolator`` / ``LagrangeInterpolator``
(linked by ``F9_JUCE_Batch_Resampler.jucer`` module list; named as the numerical
oracle by ``BASELINE.json``).  All design math is float64 NumPy, done once on the
host; the resulting bank is baked into a dense ``(W, L)`` "cycle matrix" ``G`` so
that the inner loop on the device is a single strided matmul:

    y[q*L + p] = sum_w  G[w, p] * x_padded[q*M + w]

for a rational ratio ``L/M`` (output rate / input rate).  See
`f9tpu.ops.resample` for the execution paths (XLA conv / Pallas kernel).

Design: Kaiser-windowed sinc prototype of length ``K*L`` (``K`` taps per phase),
cutoff at the band-limit of the lower of the two rates with a rolloff that fits
the transition band under the requested stopband attenuation.  Quality is
parameterised by zero-crossings-per-side ``Z`` at the limiting rate — JUCE's
WindowedSincInterpolator is a 100-crossings-per-side design, our ``"ultra"``
preset.  A Lagrange bank (order 3/5 — JUCE LagrangeInterpolator is the 5-point
member of the same family) plugs into the identical cycle-matrix structure.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from fractions import Fraction

import numpy as np

__all__ = [
    "QUALITY_PRESETS",
    "CycleBank",
    "design_cycle_bank",
    "kaiser_beta",
    "kaiser_window",
    "lagrange_phase_bank",
    "minimum_phase",
    "minphase_phase_bank",
    "resolve_ratio",
    "sinc_phase_bank",
]

# Zero crossings per side at the limiting (lower) rate, per quality preset.
# "ultra" matches the zero-crossing count of JUCE's WindowedSincInterpolator.
QUALITY_PRESETS: dict[str, int] = {
    "low": 16,
    "medium": 32,
    "high": 64,
    "ultra": 100,
}

#: Standard studio sample rates supported by the reference UI
#: (reference: Source/SettingsComponent.cpp:77-85).
STANDARD_RATES = (44100, 48000, 88200, 96000, 176400, 192000)


def resolve_ratio(rate_in: float, rate_out: float, max_denominator: int = 1 << 16) -> tuple[int, int]:
    """Return the reduced rational ``(L, M)`` with ``rate_out / rate_in = L / M``.

    Exact for all pairs of the standard studio rates (44.1/48/88.2/96/176.4/192 k;
    e.g. 44.1->48 k is 160/147).  Irrational / varispeed ratios are approximated
    by the best rational with denominator <= ``max_denominator`` (drift-free
    thereafter, since all index math is integer).
    """
    if rate_in <= 0 or rate_out <= 0:
        raise ValueError(f"invalid rates {rate_in} -> {rate_out}")
    frac = Fraction(rate_out) / Fraction(rate_in)
    frac = frac.limit_denominator(max_denominator)
    return frac.numerator, frac.denominator


def kaiser_beta(atten_db: float) -> float:
    """Kaiser window beta for a given stopband attenuation (standard formula)."""
    a = atten_db
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def _i0(x: np.ndarray) -> np.ndarray:
    """Modified Bessel function of the first kind, order 0 (float64 series).

    Implemented locally so the design has no SciPy dependency; the power series
    converges quickly for the beta range we use (<= ~16) relative to its own
    magnitude, which is all a *window* needs (the window is normalised by i0(beta)).
    """
    x = np.asarray(x, dtype=np.float64)
    half = x / 2.0
    term = np.ones_like(x)
    acc = np.ones_like(x)
    for k in range(1, 64):
        term = term * (half / k) ** 2
        acc = acc + term
        if np.all(term < 1e-24 * acc):
            break
    return acc


def kaiser_window(n: int, beta: float) -> np.ndarray:
    """Length-``n`` Kaiser window in float64."""
    if n == 1:
        return np.ones(1, dtype=np.float64)
    m = np.arange(n, dtype=np.float64)
    ratio = 2.0 * m / (n - 1) - 1.0
    return _i0(beta * np.sqrt(np.maximum(0.0, 1.0 - ratio * ratio))) / _i0(np.asarray(beta))


def _sinc(x: np.ndarray) -> np.ndarray:
    """Normalised sinc(x) = sin(pi x)/(pi x) in float64."""
    return np.sinc(x)


def sinc_phase_bank(
    L: int,
    M: int,
    taps_per_phase: int,
    atten_db: float = 140.0,
    rolloff: float | None = None,
) -> np.ndarray:
    """Kaiser-windowed-sinc polyphase bank ``H`` of shape ``(L, K)``.

    ``H[p, j] = h[j*L + p]`` for prototype ``h`` of length ``K*L`` designed at the
    ``L``-times-upsampled rate with cutoff at the lower of the input/output
    Nyquist frequencies, scaled by ``L`` for unity passband gain.

    The reference app's analog loop runs at unity rate; this bank is the software
    SRC core that replaces it (SURVEY.md section 0).
    """
    K = int(taps_per_phase)
    N = K * L
    beta = kaiser_beta(atten_db)
    if rolloff is None:
        # Fit the Kaiser transition band inside the limiting Nyquist band:
        # normalised transition width ~ (A - 7.95) / (2.285 * 2*pi * N_eff)
        # where N_eff is the prototype length in limiting-rate samples.
        n_eff = N / max(L, M)
        # Kaiser: transition width (Nyquist-normalised) ~ 2*(A-7.95)/(2.285*2*pi*N).
        # Put the cutoff *midpoint* half a transition below the limiting
        # Nyquist, so the stopband begins exactly at Nyquist and the passband
        # extends to ~(1 - transition) — e.g. ~20.5 kHz for 44.1->48 k 'high'.
        half_trans = (atten_db - 7.95) / (2.285 * 2.0 * math.pi * max(n_eff, 1.0))
        rolloff = max(0.5, 1.0 - half_trans)
    # Cutoff in cycles per upsampled sample; limiting band edge is 0.5/max(L,M).
    wc = rolloff * 0.5 / max(L, M)
    n = np.arange(N, dtype=np.float64)
    # Centre the continuous-time kernel at exactly N/2 so the group delay is an
    # *integer* number of upsampled samples — a half-integer centre leaves a
    # constant 0.5/L-input-sample misalignment that caps tone SNR near -67 dB.
    center = N // 2
    pos = n - center
    half_width = N / 2.0
    ratio = np.clip(pos / half_width, -1.0, 1.0)
    window = _i0(beta * np.sqrt(np.maximum(0.0, 1.0 - ratio * ratio))) / _i0(np.asarray(beta))
    h = 2.0 * wc * _sinc(2.0 * wc * pos) * window
    h *= L  # compensate zero-stuffing gain loss
    # Normalise exact DC gain per phase-average to 1 (keeps passband at 0 dB).
    h /= np.sum(h) / L
    return h.reshape(K, L).T.copy()  # (L, K): H[p, j] = h[j*L + p]


def minimum_phase(h: np.ndarray, nfft_factor: int = 16) -> np.ndarray:
    """Real-cepstrum (homomorphic) minimum-phase transform of an FIR,
    preserving the magnitude response in float64.

    Classic recipe: fold the real cepstrum of log|H| onto the causal side
    and re-exponentiate.  Accuracy is set by the FFT zero-padding and the
    log floor: with the default 16x padding and a -200 dB floor the
    reconstructed magnitude tracks the original to below the -140 dB
    design stopband.  ``nfft_factor`` is the zero-padding multiple,
    rounded down to a power of two.
    """
    n = int(h.shape[0])
    pad_pow = max(1, int(nfft_factor)).bit_length() - 1   # floor(log2)
    nfft = 1 << (int(np.ceil(np.log2(max(n, 2)))) + pad_pow)
    # rfft: |H| of a real input is conjugate-symmetric, so the full
    # spectrum reconstructs from the half-size transform — the complex128
    # temporaries halve, which matters for varispeed minphase banks
    # (K*L ~ 1.4-2.2M taps -> nfft 2^25-2^26; full-FFT peaked multi-GB)
    mag_h = np.abs(np.fft.rfft(h, nfft))
    mag_h = np.maximum(mag_h, mag_h.max() * 1e-10)   # -200 dB log floor
    cep = np.fft.irfft(np.log(mag_h), nfft)
    fold = np.zeros(nfft)
    fold[0] = cep[0]
    fold[1 : nfft // 2] = 2.0 * cep[1 : nfft // 2]
    fold[nfft // 2] = cep[nfft // 2]
    # exp of a conjugate-symmetric spectrum is conjugate-symmetric, so the
    # half-size transform reconstructs the real result exactly
    h_min = np.fft.irfft(np.exp(np.fft.rfft(fold)), nfft)[:n]
    return h_min


def minphase_phase_bank(
    L: int,
    M: int,
    taps_per_phase: int,
    atten_db: float = 140.0,
) -> np.ndarray:
    """Minimum-phase variant of :func:`sinc_phase_bank` — same Kaiser
    magnitude design, energy packed at the FRONT of the impulse response.

    No pre-ringing before transients (the linear-phase sinc rings
    symmetrically ahead of every edge), at the cost of frequency-dependent
    group delay near the band edge — the classic mastering-SRC filter
    choice.  The phase split/index math is identical; the bank runs through
    every execution path unchanged with ``delay_upsamples = 0`` (output
    aligns to the causal onset instead of a bulk linear delay)."""
    K = int(taps_per_phase)
    lin = sinc_phase_bank(L, M, K, atten_db=atten_db)
    # reassemble the upsampled-domain prototype, transform, re-split
    h = lin.T.reshape(K * L)        # inverse of the (L, K) phase split
    h_min = minimum_phase(h)
    h_min /= np.sum(h_min) / L      # restore exact unity DC per phase-average
    return h_min.reshape(K, L).T.copy()


def lagrange_phase_bank(L: int, order: int = 4) -> np.ndarray:
    """Lagrange interpolation bank ``H`` of shape ``(L, order+1)``.

    Phase ``p`` holds the Lagrange weights for evaluating at fractional position
    ``p / L`` between the middle pair of ``order+1`` equally spaced samples.
    ``order=4`` is the 5-point family of JUCE's ``LagrangeInterpolator``.
    """
    K = order + 1
    # The execution contract is y[n] = sum_j H[p, j] * x[base - j] with
    # base = floor(n*M/L) + order//2 (delay folded in), so tap j multiplies
    # the sample at node position (order//2 - j) relative to the evaluation
    # base — the node axis RUNS BACKWARDS in j.  Evaluate each Lagrange basis
    # at t = p/L on nodes centre - j (a mirrored mapping here would weight a
    # sample ~2 steps past the target almost like the nearest one; caught by
    # the impulse calibration, invisible to oracle-parity tests which share
    # this bank).
    centre = order // 2
    H = np.zeros((L, K), dtype=np.float64)
    nodes = [centre - j for j in range(K)]
    for p in range(L):
        t = p / L
        for j in range(K):
            xj = nodes[j]
            w = 1.0
            for m_node in nodes:
                if m_node == xj:
                    continue
                w *= (t - m_node) / (xj - m_node)
            H[p, j] = w
    return H


#: Above this many dense-matrix elements (W*L), `design_cycle_bank` skips
#: building ``G`` (varispeed ratios like 44100->44056 reduce to L/M ~
#: 11014/11025, whose dense matrix would be ~0.5 GB); such banks run through
#: the phase-table gather path (`f9tpu.ops.resample.resample_gather`) whose
#: tables are only (L, K).
DENSE_MAX_ELEMS = 4 << 20


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash (instances
# are interned by design_cycle_bank's cache, and ndarray fields aren't hashable)
class CycleBank:
    """A fully-resolved rational resampler: everything the device op needs.

    One "cycle" is ``L`` consecutive output samples produced from an ``M``-sample
    advance of the input.  ``G`` is dense ``(W, L)`` with
    ``y[q*L + p] = sum_w G[w, p] * x_padded[q*M + w]`` and
    ``x_padded = [zeros(pad_front), x, zeros(...)]``.  For varispeed ratios
    whose dense matrix would exceed `DENSE_MAX_ELEMS`, ``G`` is ``None`` and
    execution uses the phase bank ``H`` directly — production dispatch is
    the banded path (`resample_banded` / `resample_banded_rows_pre`);
    the gather path survives only as the slow cross-check.
    """

    L: int                 # upsampling factor (output samples per cycle)
    M: int                 # downsampling factor (input samples per cycle)
    taps_per_phase: int    # K — input samples contributing to one output
    G: np.ndarray | None   # (W, L) float64 cycle matrix (None: gather path)
    H: np.ndarray          # (L, K) float64 phase bank (always present)
    W_width: int           # dense width W = max cycle offset + K
    pad_front: int         # zeros to prepend to the input
    delay_upsamples: int   # prototype group delay in L-upsampled units
    kind: str              # "sinc" | "minphase" | "lagrange"

    @property
    def W(self) -> int:
        return self.W_width

    @property
    def dense_ok(self) -> bool:
        """True when the dense cycle matrix exists (matmul/conv paths)."""
        return self.G is not None

    def out_len(self, in_len: int) -> int:
        """Output length covering the same time span: ceil(in_len * L / M)."""
        return -(-in_len * self.L // self.M)

    def num_cycles(self, in_len: int) -> int:
        return -(-self.out_len(in_len) // self.L)

    def padded_in_len(self, in_len: int) -> int:
        """Total padded input length required for ``num_cycles`` windows."""
        return (self.num_cycles(in_len) - 1) * self.M + self.W


def _cycle_tables(L: int, M: int, phase_shift: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-cycle base offsets and phase indices with a constant upsample-domain
    shift folded in: for output p in [0, L), position u = p*M + phase_shift,
    off[p] = u // L, ph[p] = u % L."""
    p = np.arange(L, dtype=np.int64)
    u = p * M + phase_shift
    return (u // L).astype(np.int64), (u % L).astype(np.int64)


def _bank_to_cycle_matrix(H: np.ndarray, L: int, M: int, delay_upsamples: int,
                          build_dense: bool = True):
    """Fold a phase bank ``H (L, K)`` plus group-delay compensation into ``G``.

    Output sample n estimates the input at exact position n*M/L (zero overall
    delay), reproducing the reference's latency-compensated output contract
    (reference: _Swift Docs/LATENCY_TRIMMING_FIX.md — captured audio is shifted
    by the measured loop delay and trimmed; here the "loop" is the FIR chain and
    the delay is compensated exactly in the index math).

    ``build_dense=False`` computes only the geometry (pad_front, W) — the
    varispeed gather path executes straight from ``H``.
    """
    K = H.shape[1]
    # Raw output at upsample position u uses base floor(u/L), phase u%L, and has
    # group delay `delay_upsamples`. Evaluate at u_n = n*M + delay_upsamples.
    D_int, r = divmod(delay_upsamples, L)
    off, ph = _cycle_tables(L, M, r)
    # y[qL+p] = sum_j H[ph[p], j] * x[qM + off[p] + D_int - j]
    # Padded coords: w = off[p] + D_int - j + pad_front with pad_front = K-1-D_int
    pad_front = K - 1 - D_int
    if pad_front < 0:
        raise ValueError("delay exceeds filter span; increase taps_per_phase")
    W = int(off.max()) + K
    if not build_dense:
        return None, pad_front, W
    G = np.zeros((W, L), dtype=np.float64)
    for p in range(L):
        # j = 0..K-1 -> w = off[p] + (K-1) - j  (reversed filter)
        w_hi = off[p] + K - 1
        G[off[p]: w_hi + 1, p] = H[ph[p], ::-1]
    return G, pad_front, W


@functools.lru_cache(maxsize=64)
def design_cycle_bank(
    rate_in: int,
    rate_out: int,
    quality: str = "high",
    kind: str = "sinc",
    atten_db: float = 140.0,
    lagrange_order: int = 4,
) -> CycleBank:
    """Design the complete resampler for ``rate_in -> rate_out``.

    ``quality`` picks zero-crossings-per-side at the limiting rate
    (see QUALITY_PRESETS); taps-per-phase K = 2*Z*max(1, M/L) so quality is
    invariant to direction.  Results are cached (pure function of args).
    """
    L, M = resolve_ratio(rate_in, rate_out)
    # validate BEFORE the 1:1 shortcut: a config typo must fail for a
    # session-rate-only batch exactly as it would for any other rate pair
    if kind not in ("sinc", "minphase", "lagrange"):
        raise ValueError(f"unknown kind {kind!r}")
    if kind in ("sinc", "minphase") and quality not in QUALITY_PRESETS:
        raise ValueError(f"unknown quality {quality!r}; "
                         f"choose from {sorted(QUALITY_PRESETS)}")
    if L == 1 and M == 1:
        # 1:1 ratio is an exact passthrough (the reference validates files to the
        # session rate and copies them through the loop; Source/AppState.h:137-141).
        H = np.ones((1, 1), dtype=np.float64)
        G, pad_front, W = _bank_to_cycle_matrix(H, 1, 1, 0)
        return CycleBank(L=1, M=1, taps_per_phase=1, G=G, H=H, W_width=W,
                         pad_front=pad_front, delay_upsamples=0, kind=kind)
    if kind in ("sinc", "minphase"):
        Z = QUALITY_PRESETS[quality]
        K = max(4, int(math.ceil(2.0 * Z * max(L, M) / L)))
        # Keep K even so the group delay (K*L-1)/2 splits cleanly.
        K += K % 2
        if kind == "minphase":
            # same Kaiser magnitude, causal energy packing: no pre-ringing
            # (the mastering-SRC filter choice JUCE doesn't offer)
            H = minphase_phase_bank(L, M, K, atten_db=atten_db)
            delay_upsamples = 0
        else:
            H = sinc_phase_bank(L, M, K, atten_db=atten_db)
            delay_upsamples = (K * L) // 2
    elif kind == "lagrange":
        K = lagrange_order + 1
        H = lagrange_phase_bank(L, order=lagrange_order)
        delay_upsamples = (lagrange_order // 2) * L
    else:
        raise ValueError(f"unknown kind {kind!r}")
    # varispeed ratios (e.g. 44100->44056 = 11014/11025) would need a ~0.5 GB
    # dense matrix; keep only the (L, K) phase bank and run the gather path
    build_dense = True
    probe_W = M + K  # upper bound on W (off.max() < M + 1)
    if (probe_W + 1) * L > DENSE_MAX_ELEMS:
        build_dense = False
    G, pad_front, W = _bank_to_cycle_matrix(H, L, M, delay_upsamples,
                                            build_dense=build_dense)
    return CycleBank(
        L=L,
        M=M,
        taps_per_phase=K,
        G=G,
        H=H,
        W_width=W,
        pad_front=pad_front,
        delay_upsamples=delay_upsamples,
        kind=kind,
    )
