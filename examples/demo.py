"""End-to-end demo: 12 configurations — BASELINE.json's five plus the
round-2/3/4 feature surface (insert chain, varispeed AIFF, normalization,
streaming, minphase, FLAC in/out).

Generates a small synthetic library, then exercises each configuration
through the public CLI/API. Run on any backend (the GPU when attached):

    python examples/demo.py [workdir]
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from f9tpu.cli import main  # noqa: E402
from f9tpu.io import read_wav, write_wav  # noqa: E402
from f9tpu.models import resample_oracle  # noqa: E402


def db(err, ref):
    return 20 * np.log10(np.sqrt((err**2).mean()) / np.sqrt((ref**2).mean()) + 1e-30)


def run(workdir: str) -> None:
    rng = np.random.default_rng(0)
    lib = os.path.join(workdir, "lib")
    os.makedirs(lib, exist_ok=True)

    # --- config 1: single mono 44.1k -> 48k, parity vs the oracle ---
    mono = (0.12 * rng.standard_normal(44100)).astype(np.float32)
    write_wav(f"{lib}/mono.wav", mono, 44100, bits=24)
    rc = main(["process", f"{lib}/mono.wav", "--out", f"{workdir}/c1",
                 "--rate", "48000", "--quality", "high",
                 "--no-dither", "--keep-dc"])
    assert rc == 0
    y, _ = read_wav(f"{workdir}/c1/mono_processed.wav")
    parity = db(y[0].astype(np.float64)
                - resample_oracle(mono, 44100, 48000, quality="high"),
                resample_oracle(mono, 44100, 48000, quality="high"))
    print(f"[1] mono 44.1->48k parity vs oracle: {parity:.1f} dB (target <= -120)")
    assert parity <= -120

    # --- config 2: stereo batch 96k -> 44.1k, TPDF dither to 24-bit ---
    for i in range(3):
        x = (0.2 * rng.standard_normal((2, 96000))).astype(np.float32)
        write_wav(f"{lib}/s96_{i}.wav", x, 96000, bits=24)
    rc = main(["process", f"{lib}/s96_0.wav", f"{lib}/s96_1.wav",
                 f"{lib}/s96_2.wav", "--out", f"{workdir}/c2",
                 "--rate", "44100", "--quality", "high"])
    assert rc == 0
    print("[2] stereo 96k->44.1k batch with TPDF dither: 3/3 completed")

    # --- config 3: MCFX 8-ch with routing map ---
    bus = (0.15 * rng.standard_normal((8, 44100))).astype(np.float32)
    write_wav(f"{lib}/bus.wav", bus, 44100, bits=24)
    rc = main(["process", f"{lib}/bus.wav", "--out", f"{workdir}/c3",
                 "--rate", "48000", "--quality", "high",
                 "--routing", "7,0,-1,3"])
    assert rc == 0
    y3, _ = read_wav(f"{workdir}/c3/bus_processed.wav")
    assert y3.shape[0] == 4 and np.all(y3[2] == 0)
    print("[3] MCFX 8-ch routed to 4 buses (silent bus is digital zero)")

    # --- config 4: latency-compensated render + reverb tail trim ---
    t = np.arange(44100) / 44100
    hit = (0.4 * np.sin(2 * np.pi * 220 * t) * np.exp(-t * 8)).astype(np.float32)
    write_wav(f"{lib}/hit.wav", np.stack([hit, hit]), 44100, bits=24)
    rc = main(["process", f"{lib}/hit.wav", "--out", f"{workdir}/c4",
                 "--rate", "48000", "--quality", "high", "--reverb",
                 "--noise-floor", "-96"])
    assert rc == 0
    print("[4] reverb-mode render with auto latency calibration + tail trim")

    # --- config 5: mixed-rate library in one run ---
    for rate in (44100, 48000, 88200, 96000, 192000):
        x = (0.15 * rng.standard_normal((2, rate // 2))).astype(np.float32)
        write_wav(f"{lib}/r{rate}.wav", x, rate, bits=24)
    rc = main(["process", lib, "--out", f"{workdir}/c5",
                 "--rate", "48000", "--quality", "high", "--json"])
    assert rc == 0
    print("[5] mixed-rate studio library -> 48k in one batch")

    # --- config 6: the insert loop — convolution reverb in the chain,
    # latency measured + trimmed, tail kept to the noise floor ---
    ir_len = 24000                                   # 0.5 s ring-out @ 48k
    tt = np.arange(ir_len) / 48000
    ir = np.zeros(ir_len, np.float32)
    ir[0] = 1.0
    ir[1:] = (0.03 * rng.standard_normal(ir_len - 1)
              * np.exp(-tt[1:] / 0.12)).astype(np.float32)
    write_wav(f"{lib}/hall_ir.wav", ir[None], 48000, bits=32)
    rc = main(["process", f"{lib}/hit.wav", "--out", f"{workdir}/c6",
                 "--rate", "48000", "--quality", "high", "--reverb",
                 "--noise-floor", "-90",
                 "--chain-ir", f"{lib}/hall_ir.wav",
                 "--chain-wet", "0.6", "--chain-dry", "0.4"])
    assert rc == 0
    y6, _ = read_wav(f"{workdir}/c6/hit_processed.wav")
    src_out = int(np.ceil(44100 * 48000 / 44100))
    assert y6.shape[1] > src_out            # the tail extended past the source
    print(f"[6] insert-loop reverb: tail extended {y6.shape[1] - src_out} "
          f"frames past the source and terminated at the noise floor")

    # --- config 7: a full outboard rack in the loop — EQ -> bus compressor
    # -> tape saturation -> stereo width (the studio "insert chain") ---
    rc = main(["process", f"{lib}/s96_0.wav", "--out", f"{workdir}/c7",
                 "--rate", "48000", "--quality", "high",
                 "--chain-eq", "highshelf:8000:0.7:2.0",
                 "--chain-comp=-20:3:5:120:1",
                 "--chain-sat", "tanh:3:0.8", "--chain-width", "1.2",
                 "--seed", "1"])
    assert rc == 0
    y7, _ = read_wav(f"{workdir}/c7/s96_0_processed.wav")
    assert np.isfinite(y7).all() and np.abs(y7).max() <= 1.0
    print("[7] outboard rack: EQ -> compressor -> saturator -> width")

    # --- config 8: varispeed — NTSC pull-down 44.1k -> 44.056k via the
    # banded path (dense matrix would be ~0.5 GB), AIFF out ---
    rc = main(["process", f"{lib}/hit.wav", "--out", f"{workdir}/c8",
                 "--rate", "44056", "--quality", "high",
                 "--format", "aiff", "--seed", "1"])
    assert rc == 0
    from f9tpu.io.aiff import read_aiff
    y8, r8 = read_aiff(f"{workdir}/c8/hit_processed.aiff")
    assert r8 == 44056
    print(f"[8] NTSC pull-down 44.1k->44.056k (banded path), AIFF out: "
          f"{y8.shape[1]} frames")

    # --- config 9: loudness normalization to a streaming deliverable ---
    rc = main(["process", f"{lib}/hit.wav", f"{lib}/s96_0.wav",
                 "--out", f"{workdir}/c9", "--rate", "48000",
                 "--quality", "high", "--normalize-lufs=-16",
                 "--normalize-tp=-1", "--seed", "1"])
    assert rc == 0
    from f9tpu.ops.loudness import integrated_lufs
    import jax.numpy as jnp
    from f9tpu.ops.loudness import true_peak_db
    for stem in ("hit", "s96_0"):
        y9, r9 = read_wav(f"{workdir}/c9/{stem}_processed.wav")
        y9j = jnp.asarray(y9.astype(np.float32))
        lufs = float(integrated_lufs(y9j, r9))
        tp = float(true_peak_db(y9j, r9))
        # two-sided: AT the target, unless the dBTP ceiling held it below —
        # a one-sided bound would pass a normalizer that applied no gain
        assert (-17.0 < lufs < -15.0) or (lufs < -15.0 and tp > -1.3), (
            stem, lufs, tp)
    print("[9] loudness-normalized to -16 LUFS / -1 dBTP ceiling")

    # --- config 10 (round 3): the full streaming feature set in one pass —
    # AIFF in, routing with a silent bus, loudness-normalized, constant
    # memory ---
    from f9tpu.io.aiff import write_aiff

    quad = (0.15 * rng.standard_normal((4, 44100 * 2))).astype(np.float32)
    write_aiff(f"{lib}/quad.aiff", quad, 44100, bits=24)
    rc = main(["stream", f"{lib}/quad.aiff", "--out",
                 f"{workdir}/c10/quad48.wav", "--rate", "48000",
                 "--quality", "high", "--routing", "3,0,-1,1",
                 "--normalize-lufs=-18", "--seed", "1",
                 "--chunk-seconds", "0.5"])
    assert rc == 0
    y10, r10 = read_wav(f"{workdir}/c10/quad48.wav")
    assert r10 == 48000 and y10.shape[0] == 4 and np.all(y10[2] == 0)
    print("[10] streamed AIFF -> routed 4-bus, normalized WAV "
          "(constant memory)")

    # --- config 11 (round 3): minimum-phase SRC — no pre-ringing ahead of
    # transients (the mastering filter choice JUCE doesn't offer) ---
    rc = main(["process", f"{lib}/hit.wav", "--out", f"{workdir}/c11",
                 "--rate", "48000", "--quality", "high",
                 "--kind", "minphase", "--seed", "1"])
    assert rc == 0
    y11, r11 = read_wav(f"{workdir}/c11/hit_processed.wav")
    assert r11 == 48000 and np.isfinite(y11).all()
    print("[11] minimum-phase resample (no pre-ringing)")

    # --- config 12 (round 4): FLAC in -> FLAC out with tags carried —
    # the registerBasicFormats surface (Source/MainComponent.cpp:13) plus
    # a lossless deliverable format the reference's writer doesn't offer ---
    from f9tpu.io.flac import (insert_blocks_flac, read_extra_blocks_flac,
                               read_flac, write_flac)

    stem12 = (0.2 * rng.standard_normal((2, 44100))).astype(np.float32)
    write_flac(f"{lib}/stem.flac", stem12, 44100, bits=24)
    vc = (b"\x0a\x00\x00\x00f9tpu-demo\x01\x00\x00\x00"
          b"\x10\x00\x00\x00TITLE=Demo Stem!")
    insert_blocks_flac(f"{lib}/stem.flac", [(4, vc)])
    rc = main(["process", f"{lib}/stem.flac", "--out", f"{workdir}/c12",
                 "--rate", "48000", "--format", "flac", "--keep-metadata",
                 "--seed", "1"])
    assert rc == 0
    y12, r12 = read_flac(f"{workdir}/c12/stem_processed.flac")
    assert r12 == 48000 and y12.shape == (2, 48000)
    assert read_extra_blocks_flac(f"{workdir}/c12/stem_processed.flac") == \
        [(4, vc)]
    print("[12] FLAC -> FLAC (tags carried, MD5-verified lossless output)")

    # --- config 13 (round 5): the full drop-zone input surface in one
    # batch — Ogg Vorbis, ALAC-in-CAF, ALAC-in-M4A and MP3 sources
    # (checked-in fixtures: no encoders for lossy/Apple formats ship in
    # the product, by design) land next to a WAV and all process to 48k
    # WAV ---
    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures")
    srcs13 = [f"{fx}/tone.ogg", f"{fx}/tone.caf", f"{fx}/tone.m4a",
              f"{fx}/tone.mp3", f"{fx}/tone.au"]
    if all(os.path.exists(p) for p in srcs13):
        rc = main(["process", *srcs13, "--out", f"{workdir}/c13",
                   "--rate", "48000", "--quality", "low", "--seed", "1"])
        assert rc == 0
        outs = sorted(os.listdir(f"{workdir}/c13"))
        # same stem from four containers: collision-safe naming suffixes
        done = [o for o in outs if o.endswith(".wav")]
        assert len(done) == 5, outs
        for o in done:
            yy, rr = read_wav(f"{workdir}/c13/{o}")
            assert rr == 48000 and np.isfinite(yy).all()
        print("[13] drop-zone surface: .ogg/.caf/.m4a/.mp3/.au -> 48k WAV")
    else:
        print("[13] skipped (fixtures missing)")
    print("demo complete:", workdir)


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(prefix="f9tpu_demo_"))
