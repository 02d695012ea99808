"""Varispeed / pull-up-pull-down ratios (NTSC 44.1k->44.056k etc.).

Near-unity rational ratios reduce to huge L/M (44100->44056 = 11014/11025),
whose dense (W, L) cycle matrix would be ~0.5 GB.  `design_cycle_bank` skips
the dense build above `DENSE_MAX_ELEMS` and execution routes through the
banded path (`resample_banded`: per-cycle staircase band split into
128-output segments of small dense matrices),
with the phase-table gather path (`resample_gather`) kept as an independent
cross-check of the index contract.  Same filter design, same zero-delay
contract, so the float64 oracle remains the parity reference.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from f9tpu.config import ProcessingConfig
from f9tpu.models.filters import DENSE_MAX_ELEMS, design_cycle_bank
from f9tpu.models.oracle import resample_oracle
from f9tpu.ops.resample import cycle_matrix_f32, resample, resample_gather
from f9tpu.pipeline import BatchProcessor


def rms_db(err, ref):
    denom = np.sqrt((np.asarray(ref, np.float64) ** 2).mean()) + 1e-30
    return 20 * np.log10(np.sqrt((np.asarray(err, np.float64) ** 2).mean())
                         / denom + 1e-30)


def test_varispeed_bank_skips_dense_matrix():
    b = design_cycle_bank(44100, 44056, quality="low")
    assert b.L == 11014 and b.M == 11025
    assert b.G is None and not b.dense_ok
    assert b.H.shape == (b.L, b.taps_per_phase)
    assert (b.W + 1) * b.L > DENSE_MAX_ELEMS
    with pytest.raises(RuntimeError, match="resample_banded"):
        cycle_matrix_f32(b)
    # a mild pull (0.1%) still fits densely
    b2 = design_cycle_bank(48000, 47952, quality="low")
    assert b2.dense_ok and b2.G is not None


@pytest.mark.parametrize("rate_in,rate_out,quality", [
    (44100, 44056, "low"),      # NTSC pull-down
    (44056, 44100, "low"),      # NTSC pull-up
    (44100, 44056, "medium"),
    (192000, 44056, "low"),     # extreme: 4.36x downsample onto a pull ratio
    (44100, 44056, "ultra"),    # JUCE-oracle-grade taps on the pull ratio
])
def test_varispeed_parity_vs_oracle(rate_in, rate_out, quality):
    rng = np.random.default_rng(3)
    T = 30000
    x = (0.25 * rng.standard_normal((2, T))).astype(np.float32)
    from f9tpu.ops.resample import resample_banded

    bank = design_cycle_bank(rate_in, rate_out, quality=quality)
    assert bank.G is None
    ref = resample_oracle(x.astype(np.float64), rate_in, rate_out,
                          quality=quality)
    for fn in (resample_gather, resample_banded):
        y = np.asarray(fn(jnp.asarray(x), bank))
        assert y.shape == ref.shape
        db = rms_db(y - ref, ref)
        assert db <= -120.0, (fn.__name__, db)


def test_gather_and_banded_match_dense_on_standard_ratios():
    """Both varispeed execution forms must agree with the dense conv path
    bit-closely on ratios where all exist (same design, three executions)."""
    from f9tpu.ops.resample import resample_banded

    rng = np.random.default_rng(4)
    x = (0.3 * rng.standard_normal((1, 9000))).astype(np.float32)
    for pair in [(44100, 48000), (96000, 44100), (44100, 192000)]:
        bank = design_cycle_bank(*pair, quality="low")
        y_conv = np.asarray(resample(jnp.asarray(x), bank))
        y_gath = np.asarray(resample_gather(jnp.asarray(x), bank))
        y_band = np.asarray(resample_banded(jnp.asarray(x), bank))
        assert y_conv.shape == y_gath.shape == y_band.shape
        assert rms_db(y_conv - y_gath, y_conv) <= -130.0
        assert rms_db(y_conv - y_band, y_conv) <= -130.0


def test_varispeed_batch_pipeline(tmp_path):
    from f9tpu.io import read_wav, write_wav

    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(5)
    T = 22050
    x = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    src = str(tmp_path / "in" / "pull.wav")
    write_wav(src, x, 44100, bits=24)
    cfg = ProcessingConfig(output_dir=str(tmp_path / "out"), target_rate=44056,
                           quality="low", seed=2)
    res = BatchProcessor(cfg).run([src])
    assert res.completed == 1 and res.failed == 0
    y, r = read_wav(str(tmp_path / "out" / "pull_processed.wav"))
    assert r == 44056
    assert y.shape[1] == -(-T * 11014 // 11025)


def _marshal_banded_rows(x: np.ndarray, bank, T: int) -> np.ndarray:
    """Host marshal of `banded_rows_plan`: overlapping cycle rows via a
    strided window view of flat zero-padded staging (what the scheduler's
    flush does for varispeed rows buckets)."""
    from f9tpu.ops.resample import banded_rows_plan

    n_rows, w_row, pf = banded_rows_plan(bank, T)
    total = (n_rows - 1) * bank.M + w_row
    flat = np.zeros((*x.shape[:-1], total), np.float32)
    flat[..., pf: pf + T] = x[..., :T]
    return np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(
            flat, w_row, axis=-1)[..., :: bank.M, :])


def test_banded_rows_pre_bitwise_matches_flat():
    """The host-marshalled banded rows form must be BITWISE identical to
    `resample_banded` (they trace the same `_banded_eval_rows`: identical
    windows x identical matrices in identical order — the property that
    lets the scheduler's rows layout and the streaming/flat paths coexist
    without byte drift)."""
    from f9tpu.ops.resample import (banded_rows_applicable,
                                    resample_banded,
                                    resample_banded_rows_pre)

    rng = np.random.default_rng(11)
    for rate_out in (44056, 44100 * 1001 // 1000):
        bank = design_cycle_bank(44100, rate_out, quality="medium")
        assert bank.G is None and banded_rows_applicable(bank)
        T = 30011
        x = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
        flat = np.asarray(resample_banded(jnp.asarray(x), bank))
        xr = _marshal_banded_rows(x, bank, T)
        rows = np.asarray(resample_banded_rows_pre(jnp.asarray(xr), bank))
        n_out = bank.out_len(T)
        assert np.array_equal(rows.reshape(2, -1)[:, :n_out], flat)


def test_varispeed_rows_device_layout_byte_parity(tmp_path):
    """Scheduler with device_layout='rows' on a varispeed rate: the output
    files must be byte-identical to the default 'packed' layout run (same
    seed; no DC removal so the shared banded evaluation makes the signal
    path bitwise equal, and dither is position-keyed)."""
    from f9tpu.io import write_wav
    from f9tpu.pipeline import build_output_path

    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(12)
    T = 22050
    x = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    src = str(tmp_path / "in" / "pull.wav")
    write_wav(src, x, 44100, bits=24)
    outs = {}
    for layout in ("packed", "rows"):
        out_dir = str(tmp_path / f"out_{layout}")
        cfg = ProcessingConfig(output_dir=out_dir, target_rate=44056,
                               quality="low", seed=3, remove_dc=False,
                               device_layout=layout)
        res = BatchProcessor(cfg).run([src])
        assert res.completed == 1 and res.failed == 0
        with open(build_output_path(src, out_dir, cfg.postfix), "rb") as f:
            outs[layout] = f.read()
    assert outs["rows"] == outs["packed"]


def test_varispeed_rows_layout_with_dc_and_oracle(tmp_path):
    """Varispeed rows layout with the default DC removal: oracle parity
    (the mean's reduction order may differ from the flat graph by ULPs,
    so this gate is numerical, not byte)."""
    from f9tpu.io import read_wav, write_wav
    from f9tpu.pipeline import build_output_path

    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(13)
    T = 22050
    # headroom matters: white noise resampled overshoots its sample peaks
    # (Gibbs) and the 24-bit quantizer clips at full scale (bench.py)
    x = (0.1 * rng.standard_normal((1, T))).astype(np.float32)
    src = str(tmp_path / "in" / "vs.wav")
    write_wav(src, x, 44100, bits=24)
    cfg = ProcessingConfig(output_dir=str(tmp_path / "out"), target_rate=44056,
                           quality="medium", seed=1, dither=False,
                           device_layout="rows")
    res = BatchProcessor(cfg).run([src])
    assert res.completed == 1
    y, r = read_wav(build_output_path(src, cfg.output_dir, cfg.postfix))
    assert r == 44056
    src_x, _ = read_wav(src)
    ref = resample_oracle(src_x[0].astype(np.float64), 44100, 44056,
                          quality="medium")[: y.shape[1]]
    ref = ref - ref.mean()     # the graph removes the OUTPUT's mean
    err = y[0].astype(np.float64) - ref
    db = 20 * np.log10(np.sqrt((err**2).mean())
                       / np.sqrt((ref**2).mean()) + 1e-30)
    assert db < -95, db


def test_varispeed_streaming_matches_whole_file(tmp_path):
    from f9tpu.io import read_wav, write_wav
    from f9tpu.ops import quantize
    from f9tpu.pipeline.stream import stream_resample_file

    rng = np.random.default_rng(6)
    T = 50000
    x = (0.3 * rng.standard_normal((1, T))).astype(np.float32)
    src = str(tmp_path / "vs.wav")
    write_wav(src, x, 44100, bits=32)
    cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=44056,
                           quality="low", dither=False, remove_dc=False)
    out = str(tmp_path / "vs_out.wav")
    n = stream_resample_file(src, out, cfg, chunk_seconds=0.3)
    got, r = read_wav(out)
    assert r == 44056 and got.shape[1] == n

    xq, _ = read_wav(src)
    bank = design_cycle_bank(44100, 44056, quality="low")
    ref = np.asarray(quantize(resample_gather(jnp.asarray(xq), bank),
                              bits=24)).astype(np.float64) / (1 << 23)
    assert ref.shape[1] == n
    got_codes = np.round(got * (1 << 23))
    ref_codes = np.round(ref * (1 << 23))
    assert np.abs(got_codes - ref_codes).max() <= 4
