"""Parity of the device resample forms vs the float64 oracle, plus signal-quality
checks (alignment, DC gain, tone SNR) across the reference's supported rate
family (Source/SettingsComponent.cpp:77-85: 44.1/48/88.2/96/176.4/192 kHz)."""

import numpy as np
import pytest

from f9tpu.models.filters import design_cycle_bank, resolve_ratio
from f9tpu.models.oracle import resample_oracle
from f9tpu.ops.resample import resample_rates

RATE_PAIRS = [
    (44100, 48000),
    (48000, 44100),
    (44100, 96000),
    (96000, 44100),
    (88200, 96000),
    (96000, 192000),
    (192000, 44100),
    (44100, 44100),
]


def rms_db(err, ref):
    ref_rms = np.sqrt(np.mean(np.asarray(ref, np.float64) ** 2))
    err_rms = np.sqrt(np.mean(np.asarray(err, np.float64) ** 2))
    if err_rms == 0:
        return -np.inf
    return 20.0 * np.log10(err_rms / max(ref_rms, 1e-30))


def make_signal(n, rate, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = (
        0.4 * np.sin(2 * np.pi * 440.0 * t)
        + 0.2 * np.sin(2 * np.pi * 3301.0 * t + 0.3)
        + 0.1 * rng.standard_normal(n)
    )
    return x.astype(np.float32)


@pytest.mark.parametrize("rate_in,rate_out", RATE_PAIRS)
def test_oracle_parity(rate_in, rate_out):
    """Device path vs float64 oracle: <= -120 dB RMS (BASELINE.md target)."""
    n = 8192
    x = make_signal(n, rate_in)
    y = np.asarray(resample_rates(x, rate_in, rate_out, quality="medium"))
    ref = resample_oracle(x, rate_in, rate_out, quality="medium")
    assert y.shape == ref.shape
    assert rms_db(y - ref, ref) <= -120.0, f"{rate_in}->{rate_out}: {rms_db(y - ref, ref):.1f} dB"


@pytest.mark.parametrize("rate_in,rate_out", [(44100, 48000), (96000, 44100)])
def test_lagrange_parity(rate_in, rate_out):
    n = 4096
    x = make_signal(n, rate_in, seed=3)
    y = np.asarray(resample_rates(x, rate_in, rate_out, kind="lagrange"))
    ref = resample_oracle(x, rate_in, rate_out, kind="lagrange")
    assert rms_db(y - ref, ref) <= -120.0


def test_output_length():
    L, M = resolve_ratio(44100, 48000)
    assert (L, M) == (160, 147)
    bank = design_cycle_bank(44100, 48000, quality="low")
    assert bank.out_len(44100) == 48000
    assert bank.out_len(147) == 160


@pytest.mark.parametrize("rate_in,rate_out", [(44100, 48000), (48000, 44100), (96000, 192000)])
def test_tone_alignment_and_snr(rate_in, rate_out):
    """Resampled pure tone must match the analytically resampled tone: checks
    zero-delay alignment (the latency-compensation contract) and passband SNR."""
    f0 = 997.0
    n = 1 << 15
    t_in = np.arange(n) / rate_in
    x = np.sin(2 * np.pi * f0 * t_in).astype(np.float32)
    y = np.asarray(resample_rates(x, rate_in, rate_out, quality="high"))
    n_out = len(y)
    t_out = np.arange(n_out) / rate_out
    expected = np.sin(2 * np.pi * f0 * t_out)
    # Ignore filter-length edges.
    bank = design_cycle_bank(rate_in, rate_out, quality="high")
    edge = bank.taps_per_phase * 2
    sl = slice(edge, n_out - edge)
    err = rms_db(y[sl] - expected[sl], expected[sl])
    assert err <= -90.0, f"tone SNR too low: {err:.1f} dB"


def test_dc_gain():
    x = np.ones(8192, np.float32) * 0.5
    y = np.asarray(resample_rates(x, 44100, 48000, quality="high"))
    mid = y[2000:-2000]
    assert np.max(np.abs(mid - 0.5)) < 1e-4


def test_batch_channels_shape():
    x = make_signal(4096, 44100).reshape(1, -1) * np.ones((3, 2, 1), np.float32)
    y = np.asarray(resample_rates(x, 44100, 48000, quality="low"))
    assert y.shape[:2] == (3, 2)
    ref = resample_oracle(np.asarray(x), 44100, 48000, quality="low")
    assert rms_db(y - ref, ref) <= -120.0


def test_identity_ratio():
    """44.1 -> 44.1 must be (near-)identity: L=M=1 passthrough filter."""
    x = make_signal(4096, 44100, seed=9)
    y = np.asarray(resample_rates(x, 44100, 44100, quality="high"))
    assert y.shape == x.shape
    mid = slice(300, -300)
    assert rms_db(y[mid] - x[mid], x[mid]) <= -90.0


def test_explicit_smaller_out_len():
    """resample with out_len below the natural length must not mix batch rows
    or crash (floor-style out_len is used by the sharded paths)."""
    from f9tpu.models.filters import design_cycle_bank
    from f9tpu.ops.resample import resample
    import jax.numpy as jnp

    bank = design_cycle_bank(192000, 48000, kind="lagrange")
    x = make_signal(99, 192000).reshape(1, -1) * np.ones((2, 1), np.float32)
    out_len = 99 * bank.L // bank.M  # floor, < ceil
    y = np.asarray(resample(jnp.asarray(x), bank, out_len=out_len))
    assert y.shape == (2, out_len)
    # rows must be identical (identical inputs) — mixing would break this
    assert np.array_equal(y[0], y[1])


def test_long_sine_generator_accuracy():
    """60 s of 1 kHz at 48 kHz must stay a clean tone (float64 phase)."""
    from f9tpu.ops.signal import sine

    frames = 48000 * 60
    y, _ = sine(frames, 48000, freq=1000.0, amp=0.5)
    y = np.asarray(y, np.float64)
    t = np.arange(frames, dtype=np.float64) / 48000
    ref = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    err = np.abs(y - ref).max()
    assert err < 1e-6, err


@pytest.mark.parametrize("rate_in,rate_out", [(44100, 48000), (96000, 44100)])
def test_lagrange_tone_alignment(rate_in, rate_out):
    """Lagrange against the ANALYTIC tone, not just the shared-bank oracle —
    a mirrored node mapping once passed every parity test while weighting a
    sample ~2 steps from the target almost like the nearest one."""
    f0 = 997.0
    n = 1 << 15
    t_in = np.arange(n) / rate_in
    x = np.sin(2 * np.pi * f0 * t_in).astype(np.float32)
    y = np.asarray(resample_rates(x, rate_in, rate_out, kind="lagrange"))
    t_out = np.arange(len(y)) / rate_out
    expected = np.sin(2 * np.pi * f0 * t_out)
    sl = slice(100, len(y) - 100)
    assert rms_db(y[sl] - expected[sl], expected[sl]) <= -80.0


def test_lagrange_impulse_is_local():
    """The Lagrange impulse response must be a single local peak: weight at
    distance ~2 comparable to the nearest sample was the mirrored-bank bug."""
    from f9tpu.ops.signal import impulse

    pos = 1 << 14
    x = impulse(1 << 15, amp=0.9, position=pos)
    y = np.asarray(resample_rates(x, 44100, 48000, kind="lagrange"))
    e = int(round(pos * 160 / 147))
    window = np.abs(y[e - 4 : e + 5])
    peak = window.max()
    # all samples 2+ away from the peak are far below it
    pk_i = int(np.argmax(window))
    others = np.delete(window, [max(0, pk_i - 1), pk_i, min(len(window) - 1, pk_i + 1)])
    assert others.max() < 0.3 * peak


def test_resample_rows_pre_matches_conv_paths():
    """The host-marshalled rows form (stacked-bank matmul + shifted adds)
    must match the conv path for every quality / direction it serves."""
    import jax.numpy as jnp
    from f9tpu.ops.resample import (
        resample_rows_pre,
        rows_marshal_plan,
        rows_pre_applicable,
    )
    from f9tpu.ops.resample import resample

    rng = np.random.default_rng(9)
    for ri, ro, q in [(44100, 48000, "high"), (44100, 48000, "ultra"),
                      (96000, 44100, "high"), (48000, 44100, "low"),
                      (88200, 96000, "medium")]:
        bank = design_cycle_bank(ri, ro, quality=q)
        if not rows_pre_applicable(bank):
            continue
        T = ri // 5 + 13          # deliberately unaligned length
        x = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
        n_rows, pf = rows_marshal_plan(bank, T)
        buf = np.zeros((2, n_rows * bank.M), np.float32)
        buf[:, pf : pf + T] = x
        y = np.asarray(resample_rows_pre(
            jnp.asarray(buf.reshape(2, n_rows, bank.M)), bank))
        out_len = bank.out_len(T)
        got = y.reshape(2, -1)[:, :out_len]
        ref = np.asarray(resample(x, bank))
        assert np.abs(got - ref).max() < 2e-6, (ri, ro, q)


def test_process_batch_rows_marshalled_matches_flat():
    """The 4-D marshalled rows input through the fused graph equals the flat
    3-D input (same graph, same codes) including routing and mono fan-out."""
    import jax.numpy as jnp
    from f9tpu.config import ProcessingConfig
    from f9tpu.ops.resample import rows_marshal_plan
    from f9tpu.pipeline.graph import process_batch

    rng = np.random.default_rng(3)
    bank = design_cycle_bank(44100, 48000, quality="low")
    files, C, T = 3, 2, 5000
    x = (0.3 * rng.standard_normal((files, C, T))).astype(np.float32)
    valid = np.array([5000, 3000, 17], np.int32)
    # zero samples beyond each file's valid span (the marshalling contract)
    for i, n in enumerate(valid):
        x[i, :, n:] = 0.0
    seeds = np.arange(1, files + 1, dtype=np.int32)
    n_rows, pf = rows_marshal_plan(bank, T)
    buf = np.zeros((files, C, n_rows * bank.M), np.float32)
    buf[:, :, pf : pf + T] = x
    x4 = buf.reshape(files, C, n_rows, bank.M)

    for routing in (None, [1, 0, -1]):
        cfg = ProcessingConfig(output_dir="/tmp/x", target_rate=48000,
                               quality="low", channel_routing=routing,
                               dither=False)
        ref = process_batch(jnp.asarray(x), valid, cfg, 44100,
                            jnp.asarray(seeds), rows_layout=True)
        got = process_batch(jnp.asarray(x4), valid, cfg, 44100,
                            jnp.asarray(seeds), rows_layout=True)
        assert got.layout == "rows" and ref.layout == "rows"
        a = np.asarray(ref.codes).reshape(files, np.asarray(ref.codes).shape[1], -1)
        b = np.asarray(got.codes).reshape(files, np.asarray(got.codes).shape[1], -1)
        n = int(np.asarray(ref.out_frames)[0])
        assert np.array_equal(np.asarray(ref.out_frames),
                              np.asarray(got.out_frames))
        # different-but-equivalent compute graphs round differently at exact
        # quantizer boundaries: allow 2 LSB (accuracy is gated vs the oracle)
        np.testing.assert_allclose(a[..., :n], b[..., :n], atol=2)

    # 4-D input must be rejected off the rows fast path
    cfg = ProcessingConfig(output_dir="/tmp/x", target_rate=48000,
                           quality="low", reverb_mode=True)
    import pytest

    with pytest.raises(ValueError, match="rows fast path"):
        process_batch(jnp.asarray(x4), valid, cfg, 44100, jnp.asarray(seeds),
                      rows_layout=True)


# Banks whose flat SRC ran through the removed Pallas kernel: the flat rows
# form (pad -> row-major reshape -> `resample_rows_pre` -> flat reshape) now
# serves them on every backend.
FLAT_ROWS_BANKS = [
    (44100, 48000, "high", "sinc"),
    (96000, 44100, "high", "sinc"),
    (176400, 48000, "high", "sinc"),
    (44100, 48000, "ultra", "sinc"),
    (44100, 48000, "high", "minphase"),
]


@pytest.mark.parametrize("rate_in,rate_out,quality,kind", FLAT_ROWS_BANKS)
def test_flat_rows_form_matches_conv_and_oracle(rate_in, rate_out, quality,
                                                kind):
    from f9tpu.ops.resample import (resample, resample_auto,
                                    rows_pre_applicable)

    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    assert rows_pre_applicable(bank)
    T = rate_in // 8 + 7                      # not a multiple of M
    x = make_signal(T, rate_in, seed=11)[None].repeat(2, axis=0)
    got = np.asarray(resample_auto(x, bank))
    conv = np.asarray(resample(x, bank))
    assert got.shape == conv.shape == (2, bank.out_len(T))
    assert np.abs(got - conv).max() < 2e-6
    ref = resample_oracle(x[0], rate_in, rate_out, quality=quality, kind=kind)
    assert rms_db(got[0] - ref, ref) <= -120.0


@pytest.mark.parametrize("out_len", [None, 1, 999, 5000])
def test_resample_rows_shapes_and_padding(out_len):
    """Cycle rows hold exactly ceil(out_len / L) rows; the flat reading of
    them equals the conv for any requested out_len, short or long."""
    from f9tpu.ops.resample import resample, resample_rows

    bank = design_cycle_bank(44100, 48000, quality="low")
    x = make_signal(3001, 44100, seed=4).reshape(1, 1, -1)
    y, n = resample_rows(x, bank, out_len=out_len)
    want = bank.out_len(3001) if out_len is None else out_len
    assert n == want
    assert y.shape == (1, 1, -(-want // bank.L), bank.L)
    flat = np.asarray(y).reshape(1, 1, -1)[..., :want]
    ref = np.asarray(resample(x, bank, out_len=want))
    assert np.abs(flat - ref).max() < 2e-6


def test_resample_rows_empty_input():
    from f9tpu.ops.resample import resample_rows

    bank = design_cycle_bank(44100, 48000, quality="low")
    y, n = resample_rows(np.zeros((2, 0), np.float32), bank)
    assert n == 0 and y.shape == (2, 0, bank.L)


@pytest.mark.parametrize("rate_in,rate_out,form", [
    (44100, 48000, "rows"),
    (96000, 44100, "rows"),
    (44100, 88200, "conv"),       # M = 1: below the rows form's minimum M
    (44100, 44056, "banded"),     # varispeed: no dense cycle matrix
])
def test_resample_rates_choice_of_form(rate_in, rate_out, form):
    """`resample_rates` (calibration, R128 metering, true peak, selftest)
    takes the rows GEMM where it applies and the conv where it does not."""
    import jax

    from f9tpu.ops.resample import rows_pre_applicable

    bank = design_cycle_bank(rate_in, rate_out, quality="low")
    assert rows_pre_applicable(bank) == (form == "rows")
    x = make_signal(4410, rate_in)
    jaxpr = str(jax.make_jaxpr(
        lambda v: resample_rates(v, rate_in, rate_out, quality="low"))(x))
    assert ("conv_general_dilated" in jaxpr) == (form == "conv")
    assert ("dot_general" in jaxpr) == (form != "conv")
    y = np.asarray(resample_rates(x, rate_in, rate_out, quality="low"))
    ref = resample_oracle(x, rate_in, rate_out, quality="low")
    assert rms_db(y - ref, ref) <= -120.0
