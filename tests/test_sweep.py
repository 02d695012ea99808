"""Property sweeps: the automated form of the reference's manual checklists
(SURVEY.md section 4.4 — rate-pair x length sweeps, trim round-trip
exactness).  All pairs of the supported studio rates are exercised against
the float64 oracle."""

import numpy as np
import pytest

from f9tpu.models.filters import STANDARD_RATES, design_cycle_bank, resolve_ratio
from f9tpu.models.oracle import resample_oracle
from f9tpu.ops.resample import resample_rates

ALL_PAIRS = [(a, b) for a in STANDARD_RATES for b in STANDARD_RATES if a != b]


def rms_db(err, ref):
    return 20 * np.log10(
        np.sqrt((np.asarray(err, np.float64) ** 2).mean())
        / (np.sqrt((np.asarray(ref, np.float64) ** 2).mean()) + 1e-30)
        + 1e-30)


def test_all_rate_pairs_vs_oracle():
    """Every one of the 30 studio rate pairs: device path <= -120 dB vs oracle."""
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(4410)).astype(np.float32)
    failures = []
    for rate_in, rate_out in ALL_PAIRS:
        y = np.asarray(resample_rates(x, rate_in, rate_out, quality="low"))
        ref = resample_oracle(x, rate_in, rate_out, quality="low")
        if y.shape != ref.shape:
            failures.append((rate_in, rate_out, "shape", y.shape, ref.shape))
            continue
        db = rms_db(y - ref, ref)
        if db > -120.0:
            failures.append((rate_in, rate_out, "accuracy", db))
    assert not failures, failures


def test_all_rate_pairs_exact_ratios():
    """Ratio resolution is exact for the whole family (no drift)."""
    for rate_in, rate_out in ALL_PAIRS:
        L, M = resolve_ratio(rate_in, rate_out)
        assert rate_in * L == rate_out * M, (rate_in, rate_out)


@pytest.mark.parametrize("length", [1, 17, 146, 147, 148, 4410, 44100])
def test_length_sweep(length):
    """Ragged lengths (the file-length sweep of LATENCY_TRIMMING_FIX.md:338-353):
    exact output length and oracle parity at every size."""
    rng = np.random.default_rng(length)
    x = (0.3 * rng.standard_normal(length)).astype(np.float32)
    y = np.asarray(resample_rates(x, 44100, 48000, quality="low"))
    bank = design_cycle_bank(44100, 48000, quality="low")
    assert y.shape == (bank.out_len(length),)
    ref = resample_oracle(x, 44100, 48000, quality="low")
    assert rms_db(y - ref, ref) <= -120.0


@pytest.mark.parametrize("quality", ["low", "medium", "high"])
def test_quality_sweep(quality):
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal(8192)).astype(np.float32)
    y = np.asarray(resample_rates(x, 48000, 44100, quality=quality))
    ref = resample_oracle(x, 48000, 44100, quality=quality)
    assert rms_db(y - ref, ref) <= -120.0


def test_stopband_attenuation():
    """Filter quality: a tone above the target Nyquist must be attenuated to
    the design stopband (aliasing rejection of the anti-alias filter)."""
    rate_in, rate_out = 96000, 44100
    n = 1 << 16
    t = np.arange(n) / rate_in
    # 30 kHz tone: above 22.05 k Nyquist of the output -> must vanish
    x = np.sin(2 * np.pi * 30000.0 * t).astype(np.float32)
    y = np.asarray(resample_rates(x, rate_in, rate_out, quality="high"))
    mid = y[len(y) // 4 : -len(y) // 4]
    level_db = 20 * np.log10(np.sqrt((mid.astype(np.float64) ** 2).mean()) + 1e-30)
    assert level_db < -110.0, level_db


def test_passband_flatness():
    """Tones across the passband keep unity gain within ±0.05 dB."""
    rate_in, rate_out = 44100, 48000
    n = 1 << 15
    t = np.arange(n) / rate_in
    for freq in (100.0, 1000.0, 5000.0, 10000.0, 15000.0, 19000.0):
        x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        y = np.asarray(resample_rates(x, rate_in, rate_out, quality="high"))
        mid = y[len(y) // 4 : -len(y) // 4].astype(np.float64)
        gain_db = 20 * np.log10(np.sqrt((mid**2).mean()) / (0.5 / np.sqrt(2)))
        assert abs(gain_db) < 0.05, (freq, gain_db)


def test_varispeed_arbitrary_ratio():
    """Non-standard ratios (varispeed) go through rational approximation with
    drift-free integer index math thereafter."""
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal(8192)).astype(np.float32)
    # a 3.1% pitch-down, irrational-ish ratio
    rate_in, rate_out = 44100, 42735
    y = np.asarray(resample_rates(x, rate_in, rate_out, quality="low"))
    ref = resample_oracle(x, rate_in, rate_out, quality="low")
    assert y.shape == ref.shape
    assert rms_db(y - ref, ref) <= -120.0


def test_ultra_quality_pair():
    """The JUCE-crossing-count preset (Z=100) through the device path."""
    rng = np.random.default_rng(6)
    x = (0.3 * rng.standard_normal(8192)).astype(np.float32)
    y = np.asarray(resample_rates(x, 44100, 48000, quality="ultra"))
    ref = resample_oracle(x, 44100, 48000, quality="ultra")
    assert rms_db(y - ref, ref) <= -120.0


def test_round_trip_snr():
    """44.1 -> 48 -> 44.1 round trip: the classic SRC transparency check."""
    rng = np.random.default_rng(7)
    n = 1 << 15
    # band-limited signal (tones inside the passband)
    t = np.arange(n) / 44100
    x = sum(0.2 * np.sin(2 * np.pi * f * t + i) for i, f in
            enumerate((440.0, 1337.0, 6000.0, 15000.0)))
    x = x.astype(np.float32)
    up = np.asarray(resample_rates(x, 44100, 48000, quality="high"))
    back = np.asarray(resample_rates(up, 48000, 44100, quality="high"))[:n]
    edge = 4096
    sl = slice(edge, n - edge)
    err = back[sl].astype(np.float64) - x[sl]
    snr = -rms_db(err, x[sl])
    assert snr > 100.0, snr


def test_all_rate_pairs_rows_pre_vs_oracle():
    """The production fast path (host-marshalled rows + shift-after-dot,
    `resample_rows_pre`) across every studio rate pair it serves."""
    import jax.numpy as jnp

    from f9tpu.ops.resample import (
        resample_rows_pre,
        rows_marshal_plan,
        rows_pre_applicable,
    )

    rng = np.random.default_rng(2)
    x = (0.3 * rng.standard_normal(4410)).astype(np.float32)
    failures = []
    served = 0
    for rate_in, rate_out in ALL_PAIRS:
        bank = design_cycle_bank(rate_in, rate_out, quality="low")
        if not rows_pre_applicable(bank):
            continue
        served += 1
        n_rows, pf = rows_marshal_plan(bank, len(x))
        buf = np.zeros(n_rows * bank.M, np.float32)
        buf[pf : pf + len(x)] = x
        y = np.asarray(resample_rows_pre(
            jnp.asarray(buf.reshape(n_rows, bank.M)), bank))
        out_len = bank.out_len(len(x))
        got = y.reshape(-1)[:out_len]
        ref = resample_oracle(x, rate_in, rate_out, quality="low")
        db = rms_db(got - ref, ref)
        if db > -120.0:
            failures.append((rate_in, rate_out, db))
    assert not failures, failures
    assert served >= 18   # the fast path covers most of the matrix (tiny-M
    # pure-upsampling pairs fall back to the conv path)
