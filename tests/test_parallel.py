"""Multi-chip sharding tests on the 8-device virtual CPU mesh
(--xla_force_host_platform_device_count=8; SURVEY.md section 4 implication d)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from f9tpu.config import ProcessingConfig
from f9tpu.models.filters import design_cycle_bank
from f9tpu.models.oracle import resample_oracle
from f9tpu.ops.resample import resample, resample_rates
from f9tpu.parallel import (
    files_sharding,
    make_mesh,
    process_files_sharded,
    required_frames_padding,
    resample_frames_sharded,
)
from f9tpu.parallel.sharding import shard_halos
from f9tpu.pipeline import process_batch


def test_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    m = make_mesh()
    assert m.shape == {"files": 8, "frames": 1, "channels": 1}
    m2 = make_mesh(num_files_shards=4, num_frames_shards=2)
    assert m2.shape["frames"] == 2
    with pytest.raises(ValueError):
        make_mesh(num_files_shards=3)


def test_files_dp_matches_single_device():
    """The fused graph under files-axis sharding must produce bit-identical
    results to single-device execution (pure DP, no cross-file math)."""
    mesh = make_mesh()
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((8, 2, 4410))).astype(np.float32)
    valid = np.full(8, 4410, np.int32)
    cfg = ProcessingConfig(output_dir="/tmp/x", quality="low", dither=False,
                           remove_dc=False)
    key = jax.random.PRNGKey(0)

    res_single = process_batch(x, valid, cfg, 44100, key)
    codes_single = np.asarray(res_single.codes)

    xs = jax.device_put(jnp.asarray(x), files_sharding(mesh))
    res_sharded = process_batch(xs, valid, cfg, 44100, key)
    codes_sharded = np.asarray(res_sharded.codes)

    assert np.array_equal(codes_single, codes_sharded)
    assert np.array_equal(np.asarray(res_single.out_frames),
                          np.asarray(res_sharded.out_frames))


@pytest.mark.parametrize("rate_in,rate_out",
                         [(44100, 48000), (96000, 44100),
                          # varispeed bank (no dense matrix): the sharded
                          # path must route through the banded core too
                          (44100, 44056)])
def test_frames_sp_matches_unsharded(rate_in, rate_out):
    """Overlap-save frames sharding with ppermute halos == unsharded resample."""
    n_frames_shards = 4
    mesh = make_mesh(num_files_shards=2, num_frames_shards=n_frames_shards)
    bank = design_cycle_bank(rate_in, rate_out, quality="low")
    rng = np.random.default_rng(1)
    T0 = 40000
    pad = required_frames_padding(T0, bank, n_frames_shards)
    T = T0 + pad
    x = (0.3 * rng.standard_normal((T,))).astype(np.float32)

    y_ref = np.asarray(resample(jnp.asarray(x), bank, out_len=T * bank.L // bank.M))
    y_sh = np.asarray(resample_frames_sharded(
        jnp.asarray(x), rate_in, rate_out, mesh, quality="low"))
    assert y_sh.shape == y_ref.shape
    err = y_sh - y_ref
    denom = np.sqrt((y_ref.astype(np.float64) ** 2).mean())
    rms_db = 20 * np.log10(np.sqrt((err.astype(np.float64) ** 2).mean()) / denom + 1e-30)
    assert rms_db < -120.0, rms_db


def test_frames_sp_matches_oracle():
    mesh = make_mesh(num_files_shards=4, num_frames_shards=2)
    bank = design_cycle_bank(44100, 48000, quality="low")
    rng = np.random.default_rng(2)
    T = 2 * bank.M * 100  # exact multiple
    x = (0.3 * rng.standard_normal((T,))).astype(np.float32)
    y = np.asarray(resample_frames_sharded(jnp.asarray(x), 44100, 48000, mesh,
                                           quality="low"))
    ref = resample_oracle(x, 44100, 48000, quality="low")
    err = y[: len(ref)] - ref
    rms_db = 20 * np.log10(
        np.sqrt((err**2).mean()) / np.sqrt((ref**2).mean()) + 1e-30)
    assert rms_db < -120.0


def test_frames_sp_rejects_misaligned():
    mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
    with pytest.raises(ValueError):
        resample_frames_sharded(jnp.zeros(1001), 44100, 48000, mesh, quality="low")


def test_process_files_sharded_helper():
    mesh = make_mesh()
    x = np.ones((8, 1, 147 * 4), np.float32)
    out = process_files_sharded(
        mesh, lambda a: resample_rates(a, 44100, 48000, quality="low"), x)
    assert np.asarray(out).shape == (8, 1, 160 * 4)


def test_batch_processor_on_mesh(tmp_path):
    """The whole batch scheduler running with files-axis sharding over the
    8-device virtual mesh: outputs identical to single-device semantics."""
    from f9tpu.config import ProcessingConfig
    from f9tpu.io import read_wav, write_wav
    from f9tpu.models.oracle import resample_oracle
    from f9tpu.pipeline import BatchProcessor, build_output_path

    rng = np.random.default_rng(50)
    (tmp_path / "in").mkdir()
    paths = []
    for i in range(8):
        x = (0.15 * rng.standard_normal((2, 4410 + i))).astype(np.float32)
        p = str(tmp_path / "in" / f"m{i}.wav")
        write_wav(p, x, 44100, bits=24)
        paths.append(p)
    mesh = make_mesh()
    cfg = ProcessingConfig(output_dir=str(tmp_path / "out"), target_rate=48000,
                           quality="low", batch_size=8, dither=False,
                           remove_dc=False)
    bp = BatchProcessor(cfg, mesh=mesh)
    res = bp.run(paths)
    assert res.completed == 8
    for p in paths:
        y, r = read_wav(build_output_path(p, cfg.output_dir, cfg.postfix))
        src, _ = read_wav(p)
        ref = resample_oracle(src[0], 44100, 48000, quality="low")
        err = y[0].astype(np.float64) - ref
        db = 20 * np.log10(np.sqrt((err**2).mean())
                           / np.sqrt((ref**2).mean()) + 1e-30)
        assert db < -100, db


def test_batch_processor_mesh_batch_size_check(tmp_path):
    from f9tpu.config import ProcessingConfig
    from f9tpu.pipeline import BatchProcessor

    mesh = make_mesh()
    cfg = ProcessingConfig(output_dir=str(tmp_path), batch_size=6)
    with pytest.raises(ValueError):
        BatchProcessor(cfg, mesh=mesh)


def test_frames_sp_rejects_tiny_chunks():
    """Chunks smaller than the filter halo raise an actionable error (the
    downstream presliced length check would reject them anyway, opaquely)."""
    mesh = make_mesh(num_files_shards=1, num_frames_shards=8)
    # 44.1k->88.2k (L=2, M=1): K=200 taps -> halo ~100 input frames; 10-frame
    # chunks are far below it.  Any small-M ratio can hit this (e.g.
    # 88.2k->44.1k has M=2 and halo ~199), not just upsampling.
    T = 80
    with pytest.raises(ValueError, match="halo"):
        resample_frames_sharded(jnp.zeros(T), 44100, 88200, mesh,
                                quality="ultra")


def test_required_frames_padding_covers_halo():
    """The sizing helper must produce inputs the sharded path accepts."""
    bank = design_cycle_bank(44100, 88200, quality="ultra")  # M=1, halo ~100
    n = 8
    T0 = 80
    pad = required_frames_padding(T0, bank, n)
    T = T0 + pad
    assert T % (n * bank.M) == 0
    assert T // n >= max(shard_halos(bank))
    mesh = make_mesh(num_files_shards=1, num_frames_shards=n)
    y = resample_frames_sharded(jnp.zeros(T, jnp.float32), 44100, 88200, mesh,
                                quality="ultra")
    assert np.asarray(y).shape == (T * bank.L // bank.M,)


def test_lagrange_halo_clamped_nonnegative():
    bank = design_cycle_bank(44100, 8000, kind="lagrange")
    hl, hr = shard_halos(bank)
    assert hl >= 0 and hr >= 0


# ------------------------------------------------- channel-axis sharding (cp)


def test_channels_sharded_matches_single_device():
    """A 16-channel MCFX bus over 2 channel-shards x 4 file-shards must match
    the unsharded fused graph (metrics ride psum/pmax over the channels axis)."""
    from f9tpu.parallel import process_batch_channels_sharded

    mesh = make_mesh(num_files_shards=4, num_channel_shards=2)
    rng = np.random.default_rng(1)
    files, C, T = 4, 16, 4410
    x = (0.3 * rng.standard_normal((files, C, T))).astype(np.float32)
    valid = np.array([4410, 3000, 4410, 100], np.int32)
    seeds = np.arange(1, files + 1, dtype=np.int32)
    cfg = ProcessingConfig(output_dir="/tmp/x", quality="low", dither=False,
                           remove_dc=True)

    ref = process_batch(x, valid, cfg, 44100, jnp.asarray(seeds))
    got = process_batch_channels_sharded(x, valid, cfg, 44100, seeds, mesh)

    assert np.array_equal(np.asarray(ref.codes), np.asarray(got.codes))
    assert np.array_equal(np.asarray(ref.out_frames), np.asarray(got.out_frames))
    np.testing.assert_allclose(np.asarray(ref.peak_db), np.asarray(got.peak_db),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.rms_db), np.asarray(got.rms_db),
                               rtol=1e-5)


def test_channels_sharded_bus_local_routing():
    """Per-bus routing (each 8-channel shard routes within itself) matches the
    unsharded routed graph; cross-shard maps are rejected."""
    from f9tpu.parallel import process_batch_channels_sharded

    mesh = make_mesh(num_files_shards=4, num_channel_shards=2)
    rng = np.random.default_rng(2)
    files, C, T = 4, 16, 2205
    x = (0.3 * rng.standard_normal((files, C, T))).astype(np.float32)
    valid = np.full(files, T, np.int32)
    seeds = np.arange(files, dtype=np.int32)
    # bus-local: outputs 0-7 draw from 0-7, outputs 8-15 from 8-15, two silent
    routing = [1, 0, 3, 2, -1, 5, 6, 7, 9, 8, 11, 10, -1, 13, 14, 15]
    cfg = ProcessingConfig(output_dir="/tmp/x", quality="low", dither=False,
                           channel_routing=routing)

    ref = process_batch(x, valid, cfg, 44100, jnp.asarray(seeds))
    got = process_batch_channels_sharded(x, valid, cfg, 44100, seeds, mesh)
    assert np.array_equal(np.asarray(ref.codes), np.asarray(got.codes))

    bad = ProcessingConfig(output_dir="/tmp/x", quality="low",
                           channel_routing=[8] + list(range(1, 16)))
    with pytest.raises(ValueError, match="crosses channel shards"):
        process_batch_channels_sharded(x, valid, bad, 44100, seeds, mesh)


def test_channels_sharded_reverb_tail_verdict_consistent():
    """Reverb-mode under channel sharding: the loudest channel lives on one
    shard, but every shard must reach the same per-file end frame (pmax'd
    envelope)."""
    from f9tpu.parallel import process_batch_channels_sharded

    mesh = make_mesh(num_files_shards=2, num_channel_shards=4)
    rate_in = 44100
    files, C = 2, 8
    T = 4410
    x = np.zeros((files, C, T), np.float32)
    t = np.arange(T)
    # only channel 5 carries audio (a decaying burst); others are silent
    x[:, 5, :] = (0.5 * np.sin(2 * np.pi * 440 * t / rate_in)
                  * np.exp(-t / 800)).astype(np.float32)
    valid = np.full(files, T, np.int32)
    seeds = np.arange(files, dtype=np.int32)
    cfg = ProcessingConfig(output_dir="/tmp/x", quality="low", dither=False,
                           reverb_mode=True, noise_floor_db=-90.0)

    ref = process_batch(x, valid, cfg, rate_in, jnp.asarray(seeds))
    got = process_batch_channels_sharded(x, valid, cfg, rate_in, seeds, mesh)
    assert np.array_equal(np.asarray(ref.out_frames), np.asarray(got.out_frames))
    assert np.array_equal(np.asarray(ref.tail_terminated),
                          np.asarray(got.tail_terminated))
    assert np.array_equal(np.asarray(ref.codes), np.asarray(got.codes))


def test_channels_sharded_with_chain():
    """The insert chain runs shard-local under channel sharding."""
    from f9tpu.ops.chain import Chain, FIRInsert
    from f9tpu.parallel import process_batch_channels_sharded

    mesh = make_mesh(num_files_shards=4, num_channel_shards=2)
    rng = np.random.default_rng(3)
    files, C, T = 4, 4, 2205
    x = (0.3 * rng.standard_normal((files, C, T))).astype(np.float32)
    valid = np.full(files, T, np.int32)
    seeds = np.arange(files, dtype=np.int32)
    taps = rng.standard_normal(31).astype(np.float32) * 0.1
    taps[0] = 1.0
    cfg = ProcessingConfig(output_dir="/tmp/x", quality="low", dither=False,
                           chain=Chain(FIRInsert(taps)))
    ref = process_batch(x, valid, cfg, 44100, jnp.asarray(seeds),
                        latency_frames=0)
    got = process_batch_channels_sharded(x, valid, cfg, 44100, seeds, mesh,
                                         latency_frames=0)
    assert np.array_equal(np.asarray(ref.codes), np.asarray(got.codes))


def test_scheduler_uses_channel_sharding(tmp_path):
    """BatchProcessor on a (files x channels) mesh routes eligible groups
    through the channel-sharded graph and still produces correct WAVs."""
    from f9tpu.io import wav
    from f9tpu.pipeline import BatchProcessor

    rng = np.random.default_rng(4)
    src = tmp_path / "in"
    src.mkdir()
    files = []
    for i in range(4):
        data = (0.3 * rng.standard_normal((8, 2205))).astype(np.float32)
        p = str(src / f"bus{i}.wav")
        wav.write_wav(p, data, 44100, bits=24)
        files.append(p)

    mesh = make_mesh(num_files_shards=4, num_channel_shards=2)
    out = tmp_path / "out"
    cfg = ProcessingConfig(output_dir=str(out), target_rate=48000,
                           quality="low", batch_size=4, dither=False)
    res = BatchProcessor(cfg, mesh=mesh).run(files)
    assert res.completed == 4 and res.failed == 0

    # parity against the unsharded scheduler
    out2 = tmp_path / "out2"
    cfg2 = ProcessingConfig(output_dir=str(out2), target_rate=48000,
                            quality="low", batch_size=4, dither=False)
    res2 = BatchProcessor(cfg2).run(files)
    assert res2.completed == 4
    for i in range(4):
        a, _ = wav.read_wav(str(out / f"bus{i}_processed.wav"))
        b, _ = wav.read_wav(str(out2 / f"bus{i}_processed.wav"))
        np.testing.assert_allclose(a, b, atol=1.5 / (1 << 23))


# ------------------------------------------- multi-chip streaming (one file)


def test_stream_sharded_matches_single_chip(tmp_path):
    """One long file across chips: frames-sharded super-chunks with
    file-context outer halos must reproduce the single-chip stream exactly
    and match the float64 oracle (SURVEY.md section 7 step 6)."""
    from f9tpu.io import wav
    from f9tpu.pipeline.stream import stream_resample_file

    rate_in, rate_out = 44100, 48000
    rng = np.random.default_rng(5)
    T = int(3.3 * rate_in)
    x = (0.15 * rng.standard_normal((2, T))).astype(np.float32)
    src = str(tmp_path / "long.wav")
    wav.write_wav(src, x, rate_in, bits=32)

    cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=rate_out,
                           quality="low", dither=False, remove_dc=False)
    out1 = str(tmp_path / "single.wav")
    n1 = stream_resample_file(src, out1, cfg, chunk_seconds=0.25)

    mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
    out2 = str(tmp_path / "sharded.wav")
    n2 = stream_resample_file(src, out2, cfg, chunk_seconds=0.25, mesh=mesh)

    assert n1 == n2
    a, ra = wav.read_wav(out1)
    b, rb = wav.read_wav(out2)
    assert ra == rb
    np.testing.assert_array_equal(a, b)   # same per-shard conv shapes

    # oracle parity of the sharded output (32 f32 in, 24-bit out)
    x_read, _ = wav.read_wav(src)
    ref = resample_oracle(x_read.astype(np.float64), rate_in, rate_out,
                          quality="low")
    err = np.sqrt(np.mean((b[:, : ref.shape[1]] - ref) ** 2))
    scale = np.sqrt(np.mean(ref**2))
    assert 20 * np.log10(err / scale) <= -110   # 24-bit quantize floor


def test_stream_sharded_with_dc_and_dither(tmp_path):
    """DC pre-pass + dithered 24-bit output over the sharded path."""
    from f9tpu.io import wav
    from f9tpu.pipeline.stream import stream_resample_file

    rate_in, rate_out = 48000, 44100
    rng = np.random.default_rng(6)
    T = int(1.7 * rate_in)
    x = (0.1 * rng.standard_normal((1, T)) + 0.05).astype(np.float32)
    src = str(tmp_path / "dc.wav")
    wav.write_wav(src, x, rate_in, bits=32)
    cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=rate_out,
                           quality="low", dither=True, remove_dc=True, seed=5)
    mesh = make_mesh(num_files_shards=4, num_frames_shards=2)
    out = str(tmp_path / "o.wav")
    n = stream_resample_file(src, out, cfg, chunk_seconds=0.2, mesh=mesh)
    got, _ = wav.read_wav(out)
    assert got.shape[1] == n
    assert abs(got.mean()) < 1e-3             # DC removed
    ref = resample_oracle((x - x.mean()).astype(np.float64), rate_in,
                          rate_out, quality="low")
    err = np.sqrt(np.mean((got[:, : ref.shape[1]] - ref) ** 2))
    assert 20 * np.log10(err / np.sqrt(np.mean(ref**2))) <= -100


def test_channels_sharded_dither_decorrelated_and_reproducible():
    """Channel shards must not emit byte-identical dither noise (every shard
    holds the same per-file seed vector), and reruns must reproduce exactly."""
    from f9tpu.parallel import process_batch_channels_sharded

    mesh = make_mesh(num_files_shards=2, num_channel_shards=4)
    files, C, T = 2, 8, 2205
    # constant half-LSB signal: the dither draw alone decides each code
    x = np.full((files, C, T), 0.5 / (1 << 23), np.float32)
    valid = np.full(files, T, np.int32)
    seeds = np.array([11, 22], np.int32)
    cfg = ProcessingConfig(output_dir="/tmp/x", quality="low", dither=True,
                           remove_dc=False)
    a = np.asarray(process_batch_channels_sharded(
        x, valid, cfg, 44100, seeds, mesh).codes)
    b = np.asarray(process_batch_channels_sharded(
        x, valid, cfg, 44100, seeds, mesh).codes)
    assert np.array_equal(a, b)                      # deterministic
    c_local = C // 4
    n = int(0.9 * a.shape[-1])
    for f in range(files):
        # same local index on different shards -> different noise
        assert not np.array_equal(a[f, 0, :n], a[f, c_local, :n])
        assert not np.array_equal(a[f, 0, :n], a[f, 2 * c_local, :n])


def test_channels_sharded_dither_bytes_match_unsharded():
    """Regression: dither noise must key on the GLOBAL channel index — with
    shard-local indices, corresponding channels on different shards drew
    byte-identical (correlated) noise and sharded bytes diverged from the
    unsharded run of the same seed."""
    from f9tpu.parallel import process_batch_channels_sharded

    mesh = make_mesh(num_files_shards=4, num_channel_shards=2)
    rng = np.random.default_rng(3)
    files, C, T = 4, 16, 2205
    x = (0.3 * rng.standard_normal((files, C, T))).astype(np.float32)
    valid = np.full(files, T, np.int32)
    seeds = np.arange(10, 10 + files, dtype=np.int32)
    cfg = ProcessingConfig(output_dir="/tmp/x", quality="low", dither=True,
                           remove_dc=False)
    ref = process_batch(x, valid, cfg, 44100, jnp.asarray(seeds))
    got = process_batch_channels_sharded(x, valid, cfg, 44100, seeds, mesh)
    # the noise keys now match exactly; the residual is XLA emitting
    # z*s+noise as an FMA inside shard_map (1-ulp ties, a handful of +-1
    # codes) — mismatched noise would flip ~45% of codes by +-1..2
    diff = (np.asarray(ref.codes).astype(np.int64)
            - np.asarray(got.codes).astype(np.int64))
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.01
    # sanity: channels genuinely draw different noise (dither on silence)
    z = np.zeros((1, 4, 2205), np.float32)
    res = process_batch(z, np.full(1, T, np.int32),
                        ProcessingConfig(output_dir="/tmp/x", quality="low",
                                         dither=True, remove_dc=False),
                        44100, jnp.asarray(np.array([7], np.int32)))
    c = np.asarray(res.codes)[0]
    assert not np.array_equal(c[0], c[1])


def test_files_sharded_dither_bytes_match_unsharded(tmp_path):
    """Seeded dither bytes must be identical whether the batch runs on one
    device or files-sharded over the mesh (noise keys carry no device info)."""
    from f9tpu.config import ProcessingConfig
    from f9tpu.io import read_wav, write_wav
    from f9tpu.pipeline import BatchProcessor, build_output_path

    rng = np.random.default_rng(51)
    (tmp_path / "in").mkdir()
    paths = []
    for i in range(8):
        x = (0.2 * rng.standard_normal((2, 3000))).astype(np.float32)
        p = str(tmp_path / "in" / f"d{i}.wav")
        write_wav(p, x, 44100, bits=24)
        paths.append(p)

    def run(out, mesh):
        cfg = ProcessingConfig(output_dir=str(tmp_path / out),
                               target_rate=48000, quality="low",
                               batch_size=8, seed=4, remove_dc=False)
        assert BatchProcessor(cfg, mesh=mesh).run(paths).completed == 8
        return cfg

    c1 = run("o1", None)
    c2 = run("o2", make_mesh())
    for p in paths:
        a = open(build_output_path(p, c1.output_dir, c1.postfix), "rb").read()
        b = open(build_output_path(p, c2.output_dir, c2.postfix), "rb").read()
        assert a == b, p


def test_stream_sharded_with_routing_and_normalization(tmp_path):
    """Round-3 features on the SHARDED streaming path: channel routing with
    a silent bus + two-pass loudness normalization, frames axis over the
    mesh — must match the single-chip stream byte-for-byte (host-side
    routing gather is exact; the meter runs on the host either way)."""
    from f9tpu.io import wav
    from f9tpu.parallel import make_mesh
    from f9tpu.pipeline.stream import stream_resample_file

    rate_in, rate_out = 44100, 48000
    rng = np.random.default_rng(17)
    T = int(2.2 * rate_in)
    x = (0.15 * rng.standard_normal((4, T))).astype(np.float32)
    src = str(tmp_path / "bus_long.wav")
    wav.write_wav(src, x, rate_in, bits=24)

    cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=rate_out,
                           quality="low", seed=3, remove_dc=False,
                           channel_routing=[3, -1, 0, 1],
                           normalize_lufs=-20.0)
    o1 = str(tmp_path / "single.wav")
    n1 = stream_resample_file(src, o1, cfg, chunk_seconds=0.4)

    mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
    o2 = str(tmp_path / "sharded.wav")
    n2 = stream_resample_file(src, o2, cfg, chunk_seconds=0.4, mesh=mesh)
    assert n1 == n2
    y1, _ = wav.read_wav(o1)
    y2, _ = wav.read_wav(o2)
    assert np.all(y1[1] == 0.0) and np.all(y2[1] == 0.0)  # silent bus
    np.testing.assert_array_equal(y1, y2)


def test_scheduler_mesh_with_oversized_file_streams_single_chip(tmp_path):
    """A files-sharded batch run whose library contains a beyond-largest-
    bucket file: the oversized file streams (single-chip — its dispatch is
    sequential) while the rest ride the sharded batch graph."""
    from f9tpu.io import wav
    from f9tpu.parallel import make_mesh
    from f9tpu.pipeline import BatchProcessor

    rng = np.random.default_rng(23)
    rate = 44100
    paths = []
    for i in range(4):
        p = str(tmp_path / f"n{i}.wav")
        wav.write_wav(p, (0.2 * rng.standard_normal((2, 6_000))
                          ).astype(np.float32), rate, bits=24)
        paths.append(p)
    big = str(tmp_path / "big.wav")
    wav.write_wav(big, (0.2 * rng.standard_normal((2, 90_000))
                        ).astype(np.float32), rate, bits=24)
    paths.append(big)

    mesh = make_mesh(num_files_shards=8)
    cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                           target_rate=48000, quality="low", seed=4,
                           bucket_frames=(8_192, 16_384), batch_size=8)
    res = BatchProcessor(cfg, mesh=mesh).run(paths)
    assert res.completed == 5 and res.failed == 0
    assert res.per_file[big].get("streamed") is True


def test_channels_sharded_per_file_latency_matches_unsharded():
    """Regression: a per-file latency ARRAY must shard over the files axis.
    Replicated, every shard saw the whole vector and trim_latency's
    row-repeat pairing silently mis-assigned latencies — all codes wrong."""
    from f9tpu.parallel import process_batch_channels_sharded

    mesh = make_mesh(num_files_shards=4, num_channel_shards=2)
    rng = np.random.default_rng(9)
    files, C, T = 4, 4, 2205
    x = (0.3 * rng.standard_normal((files, C, T))).astype(np.float32)
    valid = np.full(files, T, np.int32)
    seeds = np.arange(40, 40 + files, dtype=np.int32)
    lat = jnp.asarray(np.array([0, 100, 200, 300], np.int32))
    cfg = ProcessingConfig(output_dir="/tmp/x", quality="low", dither=True,
                           remove_dc=False)
    ref = process_batch(x, valid, cfg, 44100, jnp.asarray(seeds),
                        latency_frames=lat)
    got = process_batch_channels_sharded(x, valid, cfg, 44100, seeds, mesh,
                                         latency_frames=lat)
    diff = (np.asarray(ref.codes).astype(np.int64)
            - np.asarray(got.codes).astype(np.int64))
    assert np.abs(diff).max() <= 1          # FMA-tie residual only
    assert (diff != 0).mean() < 0.01


def test_channels_sharded_rejects_channelless_mesh():
    from f9tpu.parallel import process_batch_channels_sharded

    mesh = make_mesh(num_files_shards=8)     # no channels axis
    x = np.zeros((8, 2, 441), np.float32)
    valid = np.full(8, 441, np.int32)
    seeds = np.arange(8, dtype=np.int32)
    cfg = ProcessingConfig(output_dir="/tmp/x", quality="low")
    with pytest.raises(ValueError, match="not channel-shardable"):
        process_batch_channels_sharded(x, valid, cfg, 44100, seeds, mesh)
