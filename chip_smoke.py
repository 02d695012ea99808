"""Smoke run of f9tpu's main paths on an NVIDIA GPU.

    python chip_smoke.py [--seed S]      # one card: phases A-D
    python chip_smoke.py --four          # four cards: dp, sp and cp only

Drives the public entry points (`f9tpu.cli.main`, `BatchProcessor`,
`stream_resample_file`, `resample_rates`) in this one process, at library
sizes a studio user would run, on audio generated from ``--seed`` under
``.smoke_work/`` in the checkout (removed at the end):

A. library batch, default settings: 16 x 90 s + 2 x 4 min stereo 44.1 kHz
   24-bit WAVs -> 48 kHz ``high``, with auto-calibration; run cold, then
   warm; manifest CRCs verified with ``cli verify``.
B. reverb mode + insert chain (EQ, compressor, 2 s convolution IR on the FFT
   route): 4 x 60 s stereo 96 kHz -> 48 kHz; tail verdicts checked.
C. streaming: a 10 min 96 kHz stereo file -> 48 kHz, and a 60 s 44.1 kHz
   file streamed at two chunk sizes with dither on, byte-identical.
D. accuracy against the float64 oracle (dither and DC removal off),
   <= -120 dB RMS per gate, printed with the dot precision.

``--four`` runs only the multi-card paths, each against the one-card run of
the same input: the phase-A library on a 4-way files mesh, the 10 min file
on ``--frames-shards 4``, and an 8-channel bus on a 2 x 2 files x channels
mesh.

Without a GPU the script fails before any phase.  ``--rehearse`` shrinks
every size and allows the CPU backend; it exists to check the script's
control flow without a card and is never a measurement.  Any failure exits
non-zero; on success the last stdout line is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
PRECISION = "HIGHEST (IEEE fp32, no TF32)"
GATE_DB = -120.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@dataclasses.dataclass(frozen=True)
class Sizes:
    lib_files: int = 16
    lib_seconds: float = 90.0
    song_files: int = 2
    song_seconds: float = 240.0
    reverb_files: int = 4
    reverb_seconds: float = 60.0
    ir_seconds: float = 2.0
    long_seconds: float = 600.0
    short_seconds: float = 60.0
    chunks: tuple = (20.0, 3.7)
    excerpt_seconds: float = 10.0
    bus_files: int = 4
    bus_seconds: float = 30.0


# Rehearsal keeps every path (buckets, FFT chain route, streaming chunk
# counts) but at sizes the CPU backend runs in a minute or two.
REHEARSAL = Sizes(lib_files=3, lib_seconds=2.0, song_files=1,
                  song_seconds=3.0, reverb_files=2, reverb_seconds=2.0,
                  ir_seconds=1.0, long_seconds=4.0, short_seconds=2.0,
                  chunks=(1.0, 0.37), excerpt_seconds=1.0, bus_files=2,
                  bus_seconds=1.0)


# ---------------------------------------------------------------- helpers

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_secs = [0.0]


def _on_duration(name, secs, **_kw):
    if name in _COMPILE_EVENTS:
        _compile_secs[0] += secs


def cli(argv: list[str], want_json: bool = False):
    """``f9tpu.cli.main(argv)`` in this process; rc must be 0.  With
    ``want_json`` the command's stdout is parsed as its JSON summary."""
    from f9tpu.cli import main

    print(f"$ f9tpu {' '.join(argv)}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf) if want_json else contextlib.nullcontext():
        rc = main(argv)
    check(rc == 0, f"cli {argv[0]} exited {rc}")
    return json.loads(buf.getvalue()) if want_json else None


def noise(rng, channels: int, frames: int) -> np.ndarray:
    """Seeded test audio: two tones below 4 kHz over full-band noise.  Peaks
    stay below 0.9, so no stage clips, and the tones keep the output level
    up after a downsampling filter removes the upper band, so the oracle
    gates measure the SRC and not the 24-bit quantizer."""
    t = np.arange(frames)
    f = rng.uniform(0.005, 0.08, size=(channels, 2, 1))   # cycles/sample
    ph = rng.uniform(0, 2 * np.pi, size=(channels, 2, 1))
    tones = np.sin(2 * np.pi * f * t + ph)
    x = (0.25 * tones[:, 0] + 0.15 * tones[:, 1]
         + 0.06 * rng.standard_normal((channels, frames)))
    return np.clip(x, -0.9, 0.9).astype(np.float32)


def write_set(rng, d: str, stem: str, n: int, seconds: float, rate: int,
              channels: int = 2, bits: int = 24) -> list[str]:
    from f9tpu.io import write_wav

    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(d, f"{stem}_{i:02d}.wav")
        write_wav(p, noise(rng, channels, int(seconds * rate)), rate,
                  bits=bits)
        paths.append(p)
    return paths


def out_len(frames: int, rate_in: int, rate_out: int) -> int:
    return -(-frames * rate_out // rate_in)


def decode_check(path: str, rate: int, bits: int, channels: int,
                 frames: int | None = None) -> np.ndarray:
    """The output decodes back at the expected rate, depth and shape."""
    from f9tpu.io import read_wav
    from f9tpu.io.wav import probe_wav

    info = probe_wav(path)
    check(info.sample_rate == rate and info.bit_depth == bits
          and info.num_channels == channels,
          f"{path}: {info.sample_rate} Hz {info.bit_depth}-bit "
          f"{info.num_channels} ch, want {rate} Hz {bits}-bit {channels} ch")
    if frames is not None:
        check(info.num_frames == frames,
              f"{path}: {info.num_frames} frames, want {frames}")
    y, r = read_wav(path)
    check(r == rate and np.isfinite(y).all(), f"{path}: bad decode")
    return y


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def peak_bytes(dev) -> int:
    stats = dev.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def db_err(got: np.ndarray, ref: np.ndarray) -> float:
    n = min(got.shape[-1], ref.shape[-1])
    err = got[..., :n].astype(np.float64) - ref[..., :n]
    return float(20 * np.log10(np.sqrt(np.mean(err ** 2))
                               / np.sqrt(np.mean(ref[..., :n] ** 2)) + 1e-30))


def gate(name: str, db: float) -> None:
    ok = db <= GATE_DB                  # NaN fails
    print(f"gate {name}: {db:.2f} dB RMS vs float64 oracle, precision "
          f"{PRECISION} [{'OK' if ok else 'FAIL'}]", flush=True)
    check(ok, f"gate {name}: {db:.2f} dB > {GATE_DB} dB")


def outputs(d: str) -> dict[str, str]:
    return {os.path.basename(p): p
            for p in sorted(glob.glob(os.path.join(d, "*.wav")))}


# ---------------------------------------------------------------- phases

def phase_a(rng, sz: Sizes, dev) -> list[str]:
    print("== A. library batch (default settings)", flush=True)
    lib = os.path.join(WORK, "lib")
    paths = write_set(rng, lib, "take", sz.lib_files, sz.lib_seconds, 44100)
    paths += write_set(rng, lib, "song", sz.song_files, sz.song_seconds,
                       44100)
    audio_s = sz.lib_files * sz.lib_seconds + sz.song_files * sz.song_seconds
    args = ["--rate", "48000", "--quality", "high", "--resume", "--json"]
    runs = {}
    for run in ("cold", "warm"):
        out = os.path.join(WORK, f"a_{run}")
        c0, t0 = _compile_secs[0], time.perf_counter()
        summary = cli(["process", lib, "--out", out, *args], want_json=True)
        runs[run] = (time.perf_counter() - t0, _compile_secs[0] - c0)
        check(summary["completed"] == len(paths) and summary["failed"] == 0,
              f"A {run}: {summary['completed']}/{len(paths)} completed, "
              f"{summary['failed']} failed")
    for run, (wall, comp) in runs.items():
        print(f"A {run}: wall {wall:.3f} s for {audio_s:.1f} s audio "
              f"({audio_s / wall:.1f}x real time), compile {comp:.3f} s",
              flush=True)
    from f9tpu.io.wav import probe_wav

    outs = outputs(out)
    check(len(outs) == len(paths), f"A: {len(outs)} outputs")
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        n_in = probe_wav(p).num_frames
        decode_check(outs[f"{stem}_processed.wav"], 48000, 24, 2,
                     out_len(n_in, 44100, 48000))
    report = cli(["verify", os.path.join(out, ".manifest.json"), "--json"],
                 want_json=True)
    check(report["counts"]["ok"] == len(paths),
          f"A verify: {report['counts']}")
    print(f"A: {len(paths)} files decode back at 48 kHz/24-bit, manifest "
          f"CRCs verified; peak_bytes_in_use {peak_bytes(dev)}", flush=True)
    return paths


def phase_b(rng, sz: Sizes) -> None:
    print("== B. reverb mode + insert chain", flush=True)
    from f9tpu.io import write_wav
    from f9tpu.ops.chain import FIR_FOLD_MAX

    src = os.path.join(WORK, "b_in")
    paths = write_set(rng, src, "stem", sz.reverb_files, sz.reverb_seconds,
                      96000)
    # decaying-noise IR at the session rate: -100 dB by half its length,
    # long enough for the FFT (UPOLS) route
    n_ir = int(sz.ir_seconds * 48000)
    check(n_ir > FIR_FOLD_MAX, "IR too short for the FFT route")
    t = np.arange(n_ir) / n_ir
    ir = rng.standard_normal(n_ir) * 10 ** (-100 * 2 * t / 20) * 0.01
    ir[0] = 1.0
    ir_path = os.path.join(WORK, "ir.wav")
    write_wav(ir_path, ir.astype(np.float32), 48000, bits=24)
    out = os.path.join(WORK, "b_out")
    c0, t0 = _compile_secs[0], time.perf_counter()
    summary = cli(["process", src, "--out", out, "--rate", "48000",
                   "--reverb", "--noise-floor=-96", "--margin", "10",
                   "--chain-eq", "highshelf:8000:0.7:2.5",
                   "--chain-comp=-18:3:5:120:1", "--chain-ir", ir_path,
                   "--json"], want_json=True)
    wall = time.perf_counter() - t0
    check(summary["completed"] == len(paths) and summary["failed"] == 0,
          f"B: {summary['completed']}/{len(paths)} completed")
    src_out = out_len(int(sz.reverb_seconds * 96000), 96000, 48000)
    outs = outputs(out)
    for p in paths:
        n = summary["per_file"][p]["out_frames"]
        # the tail was kept past the source span and ended (below the
        # noise floor) before the IR's own length ran out: an unterminated
        # tail fills the whole capture, which is longer than the IR
        check(src_out < n < src_out + n_ir,
              f"B tail verdict {p}: {n} frames for a {src_out}-frame source")
        stem = os.path.splitext(os.path.basename(p))[0]
        decode_check(outs[f"{stem}_processed.wav"], 48000, 24, 2, n)
        print(f"B {os.path.basename(p)}: tail ended "
              f"{(n - src_out) / 48000:.3f} s after the source", flush=True)
    print(f"B: wall {wall:.3f} s (cold, compile "
          f"{_compile_secs[0] - c0:.3f} s)", flush=True)


def phase_c(rng, sz: Sizes) -> str:
    print("== C. streaming", flush=True)
    big = write_set(rng, os.path.join(WORK, "c_in"), "master", 1,
                    sz.long_seconds, 96000)[0]
    out = os.path.join(WORK, "c_master_48k.wav")
    t0 = time.perf_counter()
    cli(["stream", big, "--out", out, "--rate", "48000"])
    wall = time.perf_counter() - t0
    decode_check(out, 48000, 24, 2,
                 out_len(int(sz.long_seconds * 96000), 96000, 48000))
    print(f"C: streamed {sz.long_seconds:.0f} s of 96 kHz in {wall:.3f} s "
          f"({sz.long_seconds / wall:.1f}x real time, cold)", flush=True)
    short = write_set(rng, os.path.join(WORK, "c_in"), "take", 1,
                      sz.short_seconds, 44100)[0]
    blobs = []
    for chunk in sz.chunks:
        o = os.path.join(WORK, f"c_take_{chunk}.wav")
        cli(["stream", short, "--out", o, "--rate", "48000", "--seed", "7",
             "--chunk-seconds", str(chunk)])
        decode_check(o, 48000, 24, 2,
                     out_len(int(sz.short_seconds * 44100), 44100, 48000))
        blobs.append(file_bytes(o))
    check(blobs[0] == blobs[1],
          f"C: dithered stream bytes differ between chunk_seconds "
          f"{sz.chunks[0]} and {sz.chunks[1]}")
    print(f"C: dithered 44.1 kHz stream byte-identical at chunk_seconds "
          f"{sz.chunks[0]} and {sz.chunks[1]}", flush=True)
    return big


def _library_gate(name: str, src: str, rate_in: int, rate_out: int,
                  quality: str, kind: str, layout: str) -> None:
    """One file through `BatchProcessor` with dither and DC removal off and
    no latency trim, then its 24-bit output against the oracle."""
    from f9tpu.config import ProcessingConfig
    from f9tpu.io import read_wav
    from f9tpu.models.oracle import resample_oracle
    from f9tpu.pipeline import BatchProcessor

    out = os.path.join(WORK, f"d_{name}")
    cfg = ProcessingConfig(output_dir=out, target_rate=rate_out,
                           quality=quality, kind=kind, dither=False,
                           remove_dc=False, latency_frames=0,
                           device_layout=layout)
    res = BatchProcessor(cfg).run([src])
    check(res.completed == 1 and res.failed == 0, f"D {name}: not completed")
    x, _ = read_wav(src)
    (got_path,) = outputs(out).values()
    got, _ = read_wav(got_path)
    ref = resample_oracle(x.astype(np.float64), rate_in, rate_out,
                          quality=quality, kind=kind)
    check(got.shape == ref.shape, f"D {name}: shape {got.shape} {ref.shape}")
    gate(name, db_err(got, ref))


def phase_d(rng, sz: Sizes, lib_file: str) -> None:
    print("== D. accuracy vs the float64 oracle", flush=True)
    import jax.numpy as jnp

    from f9tpu.models.filters import design_cycle_bank
    from f9tpu.models.oracle import resample_oracle
    from f9tpu.ops.resample import resample_rates, rows_pre_applicable

    # the whole 90 s library file (24-bit: raw-bytes upload) both layouts
    for layout in ("packed", "rows"):
        _library_gate(f"44k1_48k_high_{layout}_whole", lib_file, 44100,
                      48000, "high", "sinc", layout)
    # excerpts as 32-bit float WAVs (float upload; the rows layout then
    # takes host-marshalled rows: the dense rows GEMM / banded rows form)
    ex = os.path.join(WORK, "d_in")
    cases = [(96000, 44100, "high", "sinc", ("packed",)),
             (176400, 48000, "high", "sinc", ("packed",)),
             (44100, 48000, "ultra", "sinc", ("packed",)),
             (44100, 48000, "high", "minphase", ("packed",)),
             (44100, 44056, "high", "sinc", ("packed", "rows"))]
    for rate_in, rate_out, quality, kind, layouts in cases:
        (src,) = write_set(rng, ex, f"{rate_in}_{rate_out}_{quality}_{kind}",
                           1, sz.excerpt_seconds, rate_in, bits=32)
        for layout in layouts:
            _library_gate(f"{rate_in}_{rate_out}_{quality}_{kind}_{layout}",
                          src, rate_in, rate_out, quality, kind, layout)
    # resample_rates directly: calibration (44.1->48), R128 metering
    # (96->48) and 4x true-peak oversampling (48->192)
    for rate_in, rate_out in ((44100, 48000), (96000, 48000),
                              (48000, 192000)):
        x = noise(rng, 2, int(sz.excerpt_seconds * rate_in))
        got = np.asarray(resample_rates(jnp.asarray(x), rate_in, rate_out,
                                        quality="high"))
        ref = resample_oracle(x.astype(np.float64), rate_in, rate_out,
                              quality="high")
        bank = design_cycle_bank(rate_in, rate_out, quality="high")
        form = "rows" if rows_pre_applicable(bank) else "conv"
        gate(f"resample_rates_{rate_in}_{rate_out}_{form}", db_err(got, ref))


def phase_four(rng, sz: Sizes, big_seconds: float) -> None:
    """dp, sp and cp on four cards, each against the one-card bytes."""
    import jax

    from f9tpu.parallel import files_sharding, make_mesh
    from f9tpu.pipeline.graph import process_batch
    from f9tpu.config import ProcessingConfig

    devs = jax.devices()[:4]
    print("== dp: phase-A library, 4-way files mesh", flush=True)
    lib = os.path.join(WORK, "lib")
    paths = write_set(rng, lib, "take", sz.lib_files, sz.lib_seconds, 44100)
    paths += write_set(rng, lib, "song", sz.song_files, sz.song_seconds,
                       44100)
    walls = {}
    for tag, extra in (("one", []), ("dp4", ["--files-shards", "4"])):
        t0 = time.perf_counter()
        s = cli(["process", lib, "--out", os.path.join(WORK, f"f_{tag}"),
                 "--rate", "48000", "--quality", "high", "--json", *extra],
                want_json=True)
        walls[tag] = time.perf_counter() - t0
        check(s["completed"] == len(paths) and s["failed"] == 0,
              f"dp {tag}: {s['completed']}/{len(paths)} completed")
    _same_outputs("dp", os.path.join(WORK, "f_one"),
                  os.path.join(WORK, "f_dp4"), len(paths))
    print(f"dp: wall one card {walls['one']:.3f} s, four cards "
          f"{walls['dp4']:.3f} s (cold, compile included)", flush=True)
    # each card holds its files: the fused graph on a files-sharded batch
    cfg = ProcessingConfig(output_dir=os.path.join(WORK, "unused"),
                           target_rate=48000, quality="high")
    frames = int(sz.lib_seconds * 44100)
    x = jax.device_put(noise(rng, 2, 8 * frames).reshape(2, 8, frames)
                       .transpose(1, 0, 2).copy(),
                       files_sharding(make_mesh(4, devices=devs)))
    res = process_batch(x, np.full(8, frames, np.int32), cfg, 44100,
                        jax.random.PRNGKey(0))
    shards = [(s.device.id, s.data.shape) for s in res.codes.addressable_shards]
    print(f"dp shards of the result: {shards}", flush=True)
    check(sorted(d for d, _ in shards) == [d.id for d in devs]
          and all(shape[0] == 2 for _, shape in shards),
          f"dp: result shards {shards}")

    print("== sp: 10 min stream, --frames-shards 4", flush=True)
    big = write_set(rng, os.path.join(WORK, "c_in"), "master", 1,
                    big_seconds, 96000)[0]
    chunk = "5" if big_seconds > 60 else "0.5"
    for tag, extra in (("one", []), ("sp4", ["--frames-shards", "4"])):
        t0 = time.perf_counter()
        cli(["stream", big, "--out", os.path.join(WORK, f"s_{tag}.wav"),
             "--rate", "48000", "--chunk-seconds", chunk, *extra])
        print(f"sp {tag}: wall {time.perf_counter() - t0:.3f} s (cold)",
              flush=True)
    a = file_bytes(os.path.join(WORK, "s_one.wav"))
    b = file_bytes(os.path.join(WORK, "s_sp4.wav"))
    check(a == b, "sp: frames-sharded stream bytes differ from one card")
    print("sp: frames-sharded stream byte-identical to one card", flush=True)

    print("== cp: 8-channel bus, 2 x 2 files x channels mesh", flush=True)
    bus = os.path.join(WORK, "bus")
    write_set(rng, bus, "bus", sz.bus_files, sz.bus_seconds, 48000,
              channels=8, bits=32)
    for tag, extra in (("one", []),
                       ("cp", ["--files-shards", "2", "--channel-shards",
                               "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["process", bus, "--out", os.path.join(WORK, f"m_{tag}"),
                 "--rate", "44100", "--quality", "high", *extra])
        log = buf.getvalue()
        sys.stdout.write(log)
        check("sharding unavailable" not in log, f"cp {tag}: fell back")
    _same_outputs("cp", os.path.join(WORK, "m_one"),
                  os.path.join(WORK, "m_cp"), sz.bus_files)
    for d in devs:
        print(f"device {d.id}: peak_bytes_in_use {peak_bytes(d)}", flush=True)
        # the CPU backend of a rehearsal keeps no memory statistics
        check(peak_bytes(d) > 0 or d.platform == "cpu",
              f"device {d.id} held nothing")


def _same_outputs(tag: str, d1: str, d2: str, n: int) -> None:
    o1, o2 = outputs(d1), outputs(d2)
    check(sorted(o1) == sorted(o2) and len(o1) == n,
          f"{tag}: output sets differ")
    bad = [k for k in o1 if file_bytes(o1[k]) != file_bytes(o2[k])]
    check(not bad, f"{tag}: {len(bad)} files differ from one card: {bad}")
    print(f"{tag}: {n} outputs byte-identical to one card", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (dp, sp, cp)")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes, CPU allowed: control-flow check only")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1

    import jax
    from jax import monitoring

    from f9tpu.utils.compilecache import enable_compile_cache
    from f9tpu.utils.device import card_lines, require_gpu

    if args.rehearse:
        devs = jax.devices()
        check(len(devs) >= count, f"need {count} devices, have {len(devs)}")
    else:
        devs = require_gpu("chip_smoke", count)

    enable_compile_cache()
    monitoring.register_event_duration_secs_listener(_on_duration)
    if devs[0].platform == "gpu":
        for line in card_lines():
            print(line)
    print(f"jax {jax.__version__}; devices {jax.devices()}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    sz = REHEARSAL if args.rehearse else Sizes()
    rng = np.random.default_rng(args.seed)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.perf_counter()
    if args.four:
        phase_four(rng, sz, sz.long_seconds)
    else:
        lib = phase_a(rng, sz, devs[0])
        phase_b(rng, sz)
        phase_c(rng, sz)
        phase_d(rng, sz, lib[0])
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"all phases passed in {time.perf_counter() - t0:.3f} s "
          f"(compile {_compile_secs[0]:.3f} s)", flush=True)
    result = {"ok": True, "device": {"platform": devs[0].platform,
                                     "kind": devs[0].device_kind,
                                     "count": len(jax.devices())}}
    if args.rehearse:
        result["rehearsal"] = True
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
