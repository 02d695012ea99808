"""Config-interaction fuzz: random valid ProcessingConfigs x random small
files through the FULL BatchProcessor, asserting completion and decodable,
finite output.  Catches feature-interaction breakage (routing x dither x
format x chain x reverb x layout) that single-feature tests can miss."""

import os

import numpy as np
import pytest

from f9tpu.config import ProcessingConfig
from f9tpu.io import read_wav, write_wav
from f9tpu.io.aiff import read_aiff
from f9tpu.pipeline import BatchProcessor


def _random_cfg(rng, out_dir):
    kw = dict(output_dir=out_dir, quality="low", batch_size=4,
              bucket_frames=(2048, 8192))
    kw["target_rate"] = int(rng.choice([44100, 48000, 32000, 44056]))
    kw["bits"] = int(rng.choice([16, 24, 32]))
    kw["dither"] = bool(rng.integers(2))
    kw["remove_dc"] = bool(rng.integers(2))
    kw["gain_db"] = float(rng.choice([0.0, -6.0, 3.0]))
    kw["seed"] = int(rng.integers(100))
    kw["output_format"] = str(rng.choice(["wav", "aiff"]))
    if kw["output_format"] == "aiff" and kw["bits"] == 32:
        kw["bits"] = 24
    kw["device_layout"] = str(rng.choice(["packed", "rows"]))
    if rng.integers(2):
        kw["reverb_mode"] = True
        kw["noise_floor_db"] = -90.0
        # round 3: the C++ buffer-RMS termination rule alongside the
        # Swift peak rule
        kw["tail_mode"] = str(rng.choice(["peak", "rms"]))
    if rng.integers(3) == 0:
        from f9tpu.ops.chain import Chain, Gain, Saturator

        kw["chain"] = Chain(Gain(-1.5), Saturator("soft", 3.0, 0.7))
    if rng.integers(3) == 0:
        kw["output_channels"] = 2       # mono fan-out
    if rng.integers(3) == 0:
        kw["normalize_lufs"] = float(rng.choice([-14.0, -20.0, -24.0]))
        if rng.integers(2):
            kw["normalize_tp_db"] = -1.0
        # round 3: BS.1770 surround weighting (no-op below 6 channels but
        # must interact cleanly with the metering pre-pass)
        kw["surround_weights"] = bool(rng.integers(2))
    return ProcessingConfig(**kw)


@pytest.mark.parametrize("trial", range(8))
def test_random_config_end_to_end(tmp_path, trial):
    rng = np.random.default_rng(1000 + trial)
    (tmp_path / "in").mkdir()
    paths = []
    n_files = int(rng.integers(2, 5))
    for i in range(n_files):
        ch = int(rng.choice([1, 2]))
        frames = int(rng.integers(500, 6000))
        x = (0.3 * rng.standard_normal((ch, frames))).astype(np.float32)
        if rng.integers(2):
            x += 0.05       # DC offset
        p = str(tmp_path / "in" / f"f{i}.wav")
        write_wav(p, x, 44100, bits=int(rng.choice([16, 24, 32])))
        paths.append(p)

    cfg = _random_cfg(rng, str(tmp_path / "out"))
    if rng.integers(3) == 0 and not cfg.reverb_mode:
        # an oversized file exercises the scheduler's streaming routing
        x = (0.2 * rng.standard_normal((2, 12_000))).astype(np.float32)
        p = str(tmp_path / "in" / "big.wav")
        write_wav(p, x, 44100, bits=24)
        paths.append(p)
        n_files += 1
    # mono fan-out requires consistent channel handling with routing etc.
    res = BatchProcessor(cfg).run(paths)
    assert res.failed == 0 and res.completed == n_files, (
        trial, cfg, res.failed)

    outs = [f for f in os.listdir(tmp_path / "out")
            if f.endswith((".wav", ".aiff"))]
    assert len(outs) == n_files
    reader = read_aiff if cfg.output_format == "aiff" else read_wav
    for f in outs:
        y, r = reader(str(tmp_path / "out" / f))
        assert r == cfg.target_rate
        assert np.isfinite(y).all()
        assert y.shape[1] > 0


@pytest.mark.parametrize("trial", range(6))
def test_random_streaming_config_end_to_end(tmp_path, trial):
    """Round-3 streaming feature-interaction fuzz: random combos of
    container x routing/fan-out x normalization x latency trim x reverb
    through `stream_resample_file`, asserting exact lengths, finite decode,
    and chunk-size-invariant output length."""
    from f9tpu.io.aiff import write_aiff
    from f9tpu.models.filters import design_cycle_bank
    from f9tpu.pipeline import stream_resample_file

    rng = np.random.default_rng(7000 + trial)
    ch = int(rng.choice([1, 2, 4]))
    frames = int(rng.integers(3000, 30_000))
    x = (0.3 * rng.standard_normal((ch, frames))).astype(np.float32)
    # the full lossless + MPEG input surface feeds the same streaming
    # contract (decode is deterministic, so chunk-size byte-invariance
    # is container-independent)
    container = str(rng.choice(["wav", "aiff", "flac", "mp3"]))
    if container == "mp3":
        try:
            import avref

            ok = avref.available()
        except ImportError:        # outside pytest (tools/hw_soak.py)
            ok = False
        if not ok or ch > 2:
            container = "flac"
    src = str(tmp_path / f"s.{container}")
    if container == "flac":
        from f9tpu.io.flac import write_flac_codes

        codes24 = np.clip(np.round(x.astype(np.float64) * (1 << 23)),
                          -(1 << 23), (1 << 23) - 1).astype(np.int64)
        write_flac_codes(src, codes24, 44100, bits=24)
    elif container == "mp3":
        import avref

        codes24 = np.clip(np.round(x.astype(np.float64) * (1 << 23)),
                          -(1 << 23), (1 << 23) - 1).astype(np.int32)
        avref.encode_file_opts("libmp3lame", src, "mp3", codes24, 44100,
                               24, bit_rate=192000)
    else:
        (write_wav if container == "wav" else write_aiff)(src, x, 44100,
                                                          bits=24)

    kw = dict(output_dir=str(tmp_path), quality="low",
              target_rate=int(rng.choice([48000, 32000, 44056])),
              kind=str(rng.choice(["sinc", "minphase"])),
              bits=int(rng.choice([16, 24])),
              dither=bool(rng.integers(2)),
              remove_dc=bool(rng.integers(2)),
              seed=int(rng.integers(100)),
              gain_db=float(rng.choice([0.0, -3.0])),
              # all three incremental writers under random feature combos
              output_format=str(rng.choice(["wav", "aiff", "flac"])))
    lat = 0
    if rng.integers(2):
        lat = int(rng.integers(1, 300))
    if ch == 1 and rng.integers(2):
        kw["output_channels"] = 2
    elif ch == 4 and rng.integers(2):
        kw["channel_routing"] = [3, 0, -1, 1]
    if rng.integers(3) == 0:
        kw["normalize_lufs"] = -18.0
    reverb = bool(rng.integers(3) == 0)
    if reverb:
        kw["reverb_mode"] = True
        kw["noise_floor_db"] = -85.0
        kw["max_tail_seconds"] = 0.3
    cfg = ProcessingConfig(**kw)

    ext = {"aiff": "aiff", "flac": "flac"}.get(cfg.output_format, "wav")
    o1 = str(tmp_path / f"o1.{ext}")
    o2 = str(tmp_path / f"o2.{ext}")
    n1 = stream_resample_file(src, o1, cfg, chunk_seconds=0.11,
                              latency_frames=lat)
    n2 = stream_resample_file(src, o2, cfg, chunk_seconds=0.34,
                              latency_frames=lat)
    assert n1 == n2, (trial, kw, lat)
    # the central streaming contract: emitted BYTES are chunk-size
    # invariant (position-keyed dither, fixed-grid pre-passes, per-stage
    # chain state) — not just the length
    with open(o1, "rb") as f1, open(o2, "rb") as f2:
        bytes_equal = f1.read() == f2.read()
    if not bytes_equal:
        # XLA:CPU's conv lowering is NOT shape-invariant for every ratio:
        # different chunk lengths compile different programs whose
        # contraction order can differ at the last ulp, flipping occasional
        # rounding ties (44.1k->32k measured ~2 frames per 15k under the
        # 8-virtual-device flag).  The allowance is for the CPU backend
        # only; on the GPU (tools/hw_soak.py) the bytes must be identical.
        # Bound the backend artifact TIGHTLY so real state bugs
        # (chunk-relative dither or envelopes: +-1 code at ~every frame;
        # missing chain state: large errors) still fail loudly.
        import jax

        assert jax.default_backend() == "cpu", (trial, kw, lat)
        from f9tpu.io import codec as _codec

        ya, _ = _codec.read_audio(o1)
        yb, _ = _codec.read_audio(o2)
        scale = float(1 << (cfg.bits - 1))
        ca = np.round(ya.astype(np.float64) * scale)
        cb = np.round(yb.astype(np.float64) * scale)
        n_diff = int((ca != cb).sum())
        # the last-ulp float difference is ~1.5 LSB at 24 bit (so a few
        # percent of frames can flip) but only exact ties at 16 bit; a
        # chunk-relative dither/envelope bug differs at ~every frame and a
        # missing chain state by dB-scale errors — both still fail here
        assert np.abs(ca - cb).max() <= 2, (trial, kw, lat)
        assert n_diff <= max(8, ca.size // 20), (trial, kw, n_diff)
    bank = design_cycle_bank(44100, cfg.target_rate, quality="low",
                             kind=cfg.kind)
    expect = bank.out_len(frames)
    if reverb:
        assert expect <= n1 <= expect + int(0.3 * cfg.target_rate)
    else:
        assert n1 == expect
    from f9tpu.io import codec as _codec

    y, r = _codec.read_audio(o1)
    assert r == cfg.target_rate and np.isfinite(y).all()
    assert y.shape[1] == n1
    if "channel_routing" in kw:
        assert np.all(y[2] == 0.0)


@pytest.mark.parametrize("trial", range(4))
def test_random_sharded_streaming_matches_single_chip(tmp_path, trial):
    """Sharded-streaming fuzz across the full feature set (round 3's last
    lifted exclusions): random container x routing x normalization x chain x
    trim x reverb combos over a 4-way frames mesh.  Lengths must match
    exactly (reverb ends may differ by one hop-grid quantum of threshold
    rounding).  Samples must agree to ULP-level rounding: the per-device
    conv shapes differ here (0.4 s single-chip chunk vs 0.1 s shards), and
    XLA's reduction tiling is shape-dependent, so float32 SRC outputs can
    differ by a few ULP — measured <= 3 codes at 24 bits (~ -113 dBFS).
    Byte-identity IS guaranteed (and tested in test_parallel /
    test_stream_features) when the per-shard conv shapes match the
    single-chip chunk shape; this fuzz intentionally mismatches them to
    certify the rounding-level bound instead."""
    from f9tpu.io.aiff import write_aiff
    from f9tpu.parallel import make_mesh
    from f9tpu.pipeline import stream_resample_file

    rng = np.random.default_rng(9000 + trial)
    ch = int(rng.choice([1, 2, 4]))
    frames = int(rng.integers(20_000, 50_000))
    x = (0.3 * rng.standard_normal((ch, frames))).astype(np.float32)
    container = str(rng.choice(["wav", "aiff"]))
    src = str(tmp_path / f"s.{container}")
    (write_wav if container == "wav" else write_aiff)(src, x, 44100, bits=24)

    kw = dict(output_dir=str(tmp_path), quality="low",
              target_rate=int(rng.choice([48000, 32000, 44056])),
              bits=int(rng.choice([16, 24])),
              dither=bool(rng.integers(2)),
              remove_dc=bool(rng.integers(2)),
              seed=int(rng.integers(100)),
              gain_db=float(rng.choice([0.0, -3.0])))
    lat = int(rng.integers(1, 300)) if rng.integers(2) else 0
    if ch == 1 and rng.integers(2):
        kw["output_channels"] = 2
    elif ch == 4 and rng.integers(2):
        kw["channel_routing"] = [3, 0, -1, 1]
    if rng.integers(3) == 0:
        kw["normalize_lufs"] = -18.0
    if rng.integers(2):
        from f9tpu.ops.chain import Chain, Delay, Gain

        kw["chain"] = Chain(Gain(-1.5), Delay(0.002))
    reverb = bool(rng.integers(3) == 0)
    if reverb:
        kw["reverb_mode"] = True
        kw["noise_floor_db"] = -85.0
        kw["max_tail_seconds"] = 0.3
    cfg = ProcessingConfig(**kw)

    o1 = str(tmp_path / "single.wav")
    o2 = str(tmp_path / "sharded.wav")
    n1 = stream_resample_file(src, o1, cfg, chunk_seconds=0.4,
                              latency_frames=lat)
    mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
    n2 = stream_resample_file(src, o2, cfg, chunk_seconds=0.1, mesh=mesh,
                              latency_frames=lat)
    if reverb:
        hop = cfg.target_rate * cfg.tail_hop_ms // 1000
        assert abs(n1 - n2) <= hop, (trial, kw, n1, n2)
    else:
        assert n1 == n2, (trial, kw, lat)
    y1, _ = read_wav(o1)
    y2, _ = read_wav(o2)
    m = min(n1, n2)
    # <= 4 output codes of disagreement (ULP-level float32 divergence from
    # the mismatched conv shapes, then independent rounding)
    atol = 4.5 / (1 << (cfg.bits - 1))
    np.testing.assert_allclose(y1[:, :m], y2[:, :m], rtol=0, atol=atol)
    if "channel_routing" in kw:
        assert np.all(y2[2, :m] == 0.0)
