"""Design-characteristic regressions: pin the measured converter numbers
that docs/QUALITY.md publishes (tools/gen_quality.py) so a filter-design or
kernel change that degrades them fails CI, independent of oracle parity.

Kept to two pairs x two presets for runtime; the full matrix lives in
docs/QUALITY.md.
"""

from __future__ import annotations

import numpy as np
import pytest

from f9tpu.ops.resample import resample_rates


def _tone(freq, rate, n=1 << 15, amp=0.5):
    t = np.arange(n) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _mid(y):
    return y[len(y) // 4 : -len(y) // 4].astype(np.float64)


def _rms(x):
    return float(np.sqrt((np.asarray(x, np.float64) ** 2).mean()) + 1e-300)


def _gain_db(f, rate_in, rate_out, quality):
    y = np.asarray(resample_rates(_tone(f, rate_in), rate_in, rate_out,
                                  quality=quality))
    return 20 * np.log10(_rms(_mid(y)) / (0.5 / np.sqrt(2)))


@pytest.mark.parametrize("rate_in,rate_out", [(44100, 48000), (96000, 44100)])
def test_passband_ripple_high(rate_in, rate_out):
    """quality=high: gain error < 0.05 dB for tones up to 0.8x shared Nyq
    (QUALITY.md measures 0.01-0.02 dB)."""
    ny = 0.5 * min(rate_in, rate_out)
    for frac in (0.25, 0.5, 0.8):
        g = _gain_db(frac * ny, rate_in, rate_out, "high")
        assert abs(g) < 0.05, (frac, g)


def test_minus1db_edge_ordering():
    """The crossing count buys transition width: the -1 dB edge must march
    toward Nyquist with the preset (low < high measured 0.76 vs 0.90)."""
    ny = 0.5 * 44100

    def edge(quality):
        lo, hi = 0.5, 1.0
        for _ in range(8):
            mid = 0.5 * (lo + hi)
            if _gain_db(mid * ny, 48000, 44100, quality) > -1.0:
                lo = mid
            else:
                hi = mid
        return lo

    e_low, e_high = edge("low"), edge("high")
    assert e_high > e_low + 0.05, (e_low, e_high)
    assert e_high > 0.88, e_high


def test_alias_rejection_high():
    """A tone above the output Nyquist must be rejected > 120 dB at
    quality=high (QUALITY.md measures ~137-155 dB)."""
    rate_in, rate_out = 96000, 44100
    f = 0.5 * rate_out + 0.35 * (0.5 * rate_in - 0.5 * rate_out)
    y = np.asarray(resample_rates(_tone(f, rate_in), rate_in, rate_out,
                                  quality="high"))
    rej = -20 * np.log10(_rms(_mid(y)) / (0.5 / np.sqrt(2)))
    assert rej > 120.0, rej


def test_image_suppression_high():
    """Upsampling: spectral images above the input Nyquist suppressed
    > 130 dB at quality=high (QUALITY.md measures ~147-153 dB)."""
    rate_in, rate_out = 44100, 96000
    f = 0.45 * rate_in
    y = _mid(np.asarray(resample_rates(_tone(f, rate_in), rate_in, rate_out,
                                       quality="high")))
    w = np.hanning(len(y))
    spec = np.abs(np.fft.rfft(y * w))
    freqs = np.fft.rfftfreq(len(y), 1.0 / rate_out)
    fund = spec[(freqs > f * 0.98) & (freqs < f * 1.02)].max()
    imgs = spec[freqs > 0.5 * rate_in * 1.02].max()
    assert 20 * np.log10(fund / (imgs + 1e-300)) > 130.0


def test_thdn_coherent_high():
    """Coherent (bin-aligned, rectangular-window) THD+N of a ~1 kHz tone:
    below -125 dB — the fp32 floor, far under 24-bit delivery requirements
    (QUALITY.md measures ~-138 to -141 dB)."""
    rate_in, rate_out = 44100, 48000
    n2 = 1 << 14
    m = round(997.0 * n2 / rate_out)
    f = m * rate_out / n2
    n_in = int(2.2 * n2 * rate_in / rate_out)
    t = np.arange(n_in) / rate_in
    x = (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)
    y = np.asarray(resample_rates(x, rate_in, rate_out, quality="high"))
    off = (len(y) - n2) // 2
    y = y[off : off + n2].astype(np.float64)
    spec = np.abs(np.fft.rfft(y)) ** 2
    fund = spec[m - 2 : m + 3].sum()
    resid = spec.sum() - fund - spec[:2].sum()
    thdn = 10 * np.log10(max(resid, 1e-300) / fund)
    assert thdn < -125.0, thdn


def test_rows_graph_hbm_traffic_budget():
    """Deterministic perf tripwire (CLAUDE.md: use cost_analysis when the
    chip is noisy): the rows fused graph's total bytes-accessed must stay
    within budget for a fixed shape.  Reintroducing a device-side flat
    reshape, a duplicated SRC conv (lost optimization_barrier), or an
    explicit z materialisation shows up here as a
    2x+ jump, with zero timing noise.  Measured baseline on this shape:
    ~96 MB (CPU backend cost model); budget 130 MB."""
    import functools

    import jax
    import jax.numpy as jnp

    from f9tpu.config import ProcessingConfig
    from f9tpu.models.filters import design_cycle_bank
    from f9tpu.ops.resample import rows_marshal_plan
    from f9tpu.pipeline.graph import _cfg_key, _process_impl_rows

    cfg = ProcessingConfig(output_dir="/tmp/x", target_rate=48000,
                           quality="low")
    bank = design_cycle_bank(44100, 48000, quality="low")
    files, ch, frames = 4, 2, 1 << 17
    n_rows, _pf = rows_marshal_plan(bank, frames)
    x = jnp.zeros((files, ch, n_rows, bank.M), jnp.float32)
    valid = jnp.full((files,), frames, jnp.int32)
    f = functools.partial(_process_impl_rows, rate_in=44100, rate_out=48000,
                          cfg_key=_cfg_key(cfg, 0))
    ca = jax.jit(f).lower(x, valid, jax.random.PRNGKey(0)).compile() \
        .cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    bytes_accessed = ca.get("bytes accessed")
    assert bytes_accessed is not None
    assert bytes_accessed < 130e6, f"{bytes_accessed / 1e6:.1f} MB"


def test_banded_rows_hbm_traffic_budget():
    """Banded (varispeed) twin of the rows tripwire: ``_banded_eval_rows``
    must keep consuming lane-aligned slices of the marshalled rows directly
    (one dot per segment).  Reintroducing the
    stacked (Q, S, w) segment-window tensor costs a full extra HBM
    write+read pass — measured 103 MB on this shape vs 53 MB for the
    per-segment form (CPU cost model).  Budget 70 MB sits between the
    two."""
    import jax
    import jax.numpy as jnp

    from f9tpu.models.filters import design_cycle_bank
    from f9tpu.ops.resample import banded_rows_plan, resample_banded_rows_pre

    bank = design_cycle_bank(44100, 44056, quality="high")
    frames = 1 << 17
    n_rows, w_row, _pf = banded_rows_plan(bank, frames)
    x = jnp.zeros((4, 2, n_rows, w_row), jnp.float32)
    ca = jax.jit(lambda r: resample_banded_rows_pre(r, bank)) \
        .lower(x).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    bytes_accessed = ca.get("bytes accessed")
    assert bytes_accessed is not None
    assert bytes_accessed < 70e6, f"{bytes_accessed / 1e6:.1f} MB"


class TestMinimumPhase:
    """kind="minphase": the mastering-SRC filter choice (no pre-ringing)
    beyond JUCE's two interpolators — same Kaiser magnitude design, energy
    packed causally via the real-cepstrum transform (models/filters.py)."""

    def test_device_vs_oracle_parity(self):
        rng = np.random.default_rng(0)
        x = (0.3 * rng.standard_normal(16384)).astype(np.float32)
        from f9tpu.models.oracle import resample_oracle

        for r_in, r_out in [(44100, 48000), (96000, 44100)]:
            y = np.asarray(resample_rates(x, r_in, r_out, quality="high",
                                          kind="minphase")).astype(np.float64)
            ref = resample_oracle(x, r_in, r_out, quality="high",
                                  kind="minphase")
            err = y - ref
            db = 20 * np.log10(_rms(err) / _rms(ref))
            assert db <= -120, (r_in, r_out, db)

    def test_magnitude_matches_linear_phase_design(self):
        def gain(f, kind):
            y = np.asarray(resample_rates(_tone(f, 44100), 44100, 48000,
                                          quality="high", kind=kind))
            return 20 * np.log10(_rms(_mid(y)) / (0.5 / np.sqrt(2)))

        for f in (997.0, 10_000.0, 18_000.0):
            assert abs(gain(f, "sinc") - gain(f, "minphase")) < 0.02, f

    def test_prering_suppressed_vs_linear_phase(self):
        imp = np.zeros(4096, np.float32)
        imp[2048] = 1.0

        def prering(kind):
            y = np.asarray(resample_rates(imp, 44100, 48000, quality="high",
                                          kind=kind)).astype(np.float64)
            pk = int(np.argmax(np.abs(y)))
            return float((y[: max(0, pk - 2)] ** 2).sum() / (y**2).sum())

        r_lin, r_min = prering("sinc"), prering("minphase")
        # linear phase rings symmetrically AHEAD of the transient; the
        # minimum-phase version keeps a causal ramp only — two-plus orders
        # of magnitude less pre-transient energy (measured ~660x)
        assert r_lin > 1e-3
        assert r_min < 1e-4 and r_min < r_lin / 100.0, (r_lin, r_min)

    def test_alias_rejection_preserved(self):
        y = np.asarray(resample_rates(_tone(30_000.0, 96000), 96000, 44100,
                                      quality="high", kind="minphase"))
        rej = -20 * np.log10(_rms(_mid(y)) / (0.5 / np.sqrt(2)))
        assert rej > 110.0, rej

    def test_pipeline_end_to_end(self, tmp_path):
        from f9tpu.config import ProcessingConfig
        from f9tpu.io import read_wav, write_wav
        from f9tpu.pipeline import BatchProcessor

        rng = np.random.default_rng(4)
        src = str(tmp_path / "m.wav")
        write_wav(src, (0.3 * rng.standard_normal((2, 9000))
                        ).astype(np.float32), 44100, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                               target_rate=48000, quality="low",
                               kind="minphase", seed=2)
        assert BatchProcessor(cfg).run([src]).completed == 1
        y, r = read_wav(str(tmp_path / "out" / "m_processed.wav"))
        assert r == 48000 and np.isfinite(y).all()


def test_varispeed_banded_characteristics():
    """Varispeed (NTSC 44.1k->44.056k, L/M = 11014/11025) has no dense cycle
    matrix — it runs the banded path.  Pin its design characteristics
    independently of oracle parity (QUALITY.md measures 0.005 dB ripple and
    136.6 dB alias rejection at quality=high)."""
    from f9tpu.models.filters import design_cycle_bank

    rate_in, rate_out = 44100, 44056
    bank = design_cycle_bank(rate_in, rate_out, quality="high")
    assert bank.G is None  # certifying the banded path, not the dense one

    ny = 0.5 * rate_out
    for frac in (0.25, 0.8):
        g = _gain_db(frac * ny, rate_in, rate_out, "high")
        assert abs(g) < 0.05, (frac, g)

    # a tone between the output and input Nyquists must not survive
    f = ny + 0.35 * (0.5 * rate_in - ny)
    y = np.asarray(resample_rates(_tone(f, rate_in), rate_in, rate_out,
                                  quality="high"))
    rej = -20 * np.log10(_rms(_mid(y)) / (0.5 / np.sqrt(2)))
    assert rej > 120.0, rej
