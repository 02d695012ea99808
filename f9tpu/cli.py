"""Command-line interface — the L6 layer (the reference's SwiftUI/JUCE GUI,
SURVEY.md section 1, re-expressed as a CLI for a headless device pipeline).

Subcommands mirror the app's user actions:
  process   "Process All" batch run  (MainViewModel.processAllFiles)
  stream    constant-memory resample of one long file
  preview   playlist render           (togglePreview / previewFiles)
  measure   latency calibration       (measureLatency)
  selftest  hardware loop test        (startHardwareTest)
  probe     file metadata / validation (AudioFile metadata load)
  watch     folder watcher: the drop-zone workflow, headless
  verify    audit a manifest's outputs by size + CRC-32
  devices   compute device enumeration (refreshDevices)

``--config FILE`` loads defaults from JSON and ``--save-config FILE`` writes
the resolved settings back — the settings persistence the reference lists as
TODO (Docs/debug-notes.md:88).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from .config import ProcessingConfig
from .io import codec, wav
from .pipeline import (
    BatchProcessor,
    CalibrationCache,
    StatusLog,
    measure_latency,
    render_playlist,
    run_loop_test,
)

__all__ = ["main"]


def _expand_inputs(inputs: list[str]) -> list[str]:
    files: list[str] = []
    for item in inputs:
        if os.path.isdir(item):
            files.extend(sorted(
                os.path.join(item, name) for name in os.listdir(item)
                if codec.is_supported(name)))  # case-insensitive (.WAV etc.)
        elif os.path.exists(item):
            # literal path FIRST: glob characters are legal in filenames
            # ('take[1].wav' must not be eaten as an unmatched pattern)
            files.append(item)
        elif any(ch in item for ch in "*?["):
            files.extend(sorted(glob.glob(item)))  # unmatched glob -> nothing
        else:
            files.append(item)  # literal path: let probe report the error
    seen, out = set(), []
    for f in files:
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


def _add_common_src_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--rate", type=int, default=48000, help="target sample rate")
    p.add_argument("--quality", default="high",
                   choices=["low", "medium", "high", "ultra"])
    p.add_argument("--kind", default="sinc",
                   choices=["sinc", "minphase", "lagrange"],
                   help="filter family: linear-phase sinc (default), minimum-phase sinc (no pre-ringing), or Lagrange polynomial")


#: process-command options persisted by --save-config / applied by --config.
#: Stored under their CLI names so the round-trip is exact.
_CONFIG_KEYS = (
    "rate", "quality", "kind", "bits", "postfix", "output_format",
    "no_dither", "keep_dc", "normalize_lufs", "normalize_tp_db",
    "surround_weights", "keep_metadata",
    "gain", "reverb", "noise_floor", "margin", "require_rate", "batch_size",
    "routing", "channels", "device_layout", "seed", "latency",
    "chain_ir", "chain_wet", "chain_dry", "chain_fir", "chain_delay_ms",
    "chain_eq", "chain_comp", "chain_sat", "chain_width",
    "chain_gate", "chain_limit",
)


def _parse_routing(spec):
    """'0,1,-1,2' -> [0, 1, -1, 2] with a clean usage error on junk."""
    if not spec:
        return None
    try:
        return [int(c) for c in spec.split(",")]
    except ValueError:
        raise SystemExit(
            f"error: --routing must be comma-separated integers "
            f"(-1 = silent), got {spec!r}")


def _build_chain(args):
    """Assemble the insert chain from CLI flags (the reference's external
    processor loop, expressed as in-graph stages).  Studio signal order:
    delay -> gate -> EQ -> FIR -> compressor -> saturator -> width ->
    reverb -> limiter, each optional."""
    from .ops.chain import (Biquad, Chain, Compressor, ConvolutionReverb,
                            Delay, Expander, FIRInsert, Limiter, Saturator,
                            StereoWidth)

    stages = []
    if getattr(args, "chain_delay_ms", None):
        try:
            stages.append(Delay(args.chain_delay_ms / 1000.0))
        except ValueError as e:
            raise SystemExit(f"--chain-delay-ms: {e}")
    if getattr(args, "chain_gate", None):
        parts = str(args.chain_gate).split(":")
        if not 2 <= len(parts) <= 5:
            raise SystemExit("--chain-gate expects "
                             "thresh_db:ratio[:release_db_s[:range_db"
                             f"[:attack_ms]]], got {args.chain_gate!r}")
        try:
            stages.append(Expander(
                threshold_db=float(parts[0]), ratio=float(parts[1]),
                release_db_per_s=(float(parts[2]) if len(parts) > 2
                                  else 200.0),
                range_db=float(parts[3]) if len(parts) > 3 else 60.0,
                attack_ms=float(parts[4]) if len(parts) > 4 else 0.0))
        except ValueError as e:
            raise SystemExit(f"--chain-gate: {e}")
    for spec in getattr(args, "chain_eq", None) or []:
        parts = spec.split(":")
        if not 2 <= len(parts) <= 4:
            raise SystemExit(
                f"--chain-eq expects kind:freq[:q[:gain_db]], got {spec!r}")
        try:
            kind, freq = parts[0], float(parts[1])
            q = float(parts[2]) if len(parts) > 2 else 0.70710678
            gain = float(parts[3]) if len(parts) > 3 else 0.0
            stages.append(Biquad(kind, freq, q=q, gain_db=gain))
        except ValueError as e:
            raise SystemExit(f"--chain-eq {spec!r}: {e}")
    def _read_at_session_rate(path):
        # filters/IRs captured at another rate keep their frequency response
        # by oracle-resampling (host float64, exact) to the session rate
        try:
            arr, arr_rate = codec.read_audio(path)
        except (OSError, ValueError) as e:
            raise SystemExit(f"error: cannot read chain file {path}: {e}")
        if arr_rate != args.rate:
            from .models.oracle import resample_oracle

            arr = resample_oracle(arr.astype(np.float64), arr_rate,
                                  args.rate).astype(np.float32)
        return arr


    if getattr(args, "chain_fir", None):
        taps = _read_at_session_rate(args.chain_fir)
        stages.append(FIRInsert(taps[0]))
    if getattr(args, "chain_comp", None):
        parts = str(args.chain_comp).split(":")
        if not 2 <= len(parts) <= 5:
            raise SystemExit("--chain-comp expects "
                             "thresh_db:ratio[:attack_ms[:release_db_s"
                             f"[:makeup_db]]], got {args.chain_comp!r}")
        try:
            stages.append(Compressor(
                threshold_db=float(parts[0]), ratio=float(parts[1]),
                attack_ms=float(parts[2]) if len(parts) > 2 else 5.0,
                release_db_per_s=(float(parts[3]) if len(parts) > 3 else 80.0),
                makeup_db=float(parts[4]) if len(parts) > 4 else 0.0))
        except ValueError as e:
            raise SystemExit(f"--chain-comp: {e}")
    if getattr(args, "chain_sat", None):
        parts = str(args.chain_sat).split(":")
        if not 2 <= len(parts) <= 3:
            raise SystemExit("--chain-sat expects kind:drive_db[:mix], "
                             f"got {args.chain_sat!r}")
        try:
            stages.append(Saturator(parts[0], drive_db=float(parts[1]),
                                    mix=(float(parts[2]) if len(parts) > 2
                                         else 1.0)))
        except ValueError as e:
            raise SystemExit(f"--chain-sat: {e}")
    if getattr(args, "chain_width", None) is not None:
        try:
            stages.append(StereoWidth(float(args.chain_width)))
        except ValueError as e:
            raise SystemExit(f"--chain-width: {e}")
    if getattr(args, "chain_ir", None):
        ir = _read_at_session_rate(args.chain_ir)
        if ir.shape[0] == 1:
            ir = ir[0]
        stages.append(ConvolutionReverb(ir, wet=args.chain_wet,
                                        dry=args.chain_dry))
    if getattr(args, "chain_limit", None):
        parts = str(args.chain_limit).split(":")
        if not 1 <= len(parts) <= 3:
            raise SystemExit("--chain-limit expects "
                             "ceiling_db[:lookahead_ms[:release_db_s]], "
                             f"got {args.chain_limit!r}")
        try:
            stages.append(Limiter(
                ceiling_db=float(parts[0]),
                lookahead_ms=float(parts[1]) if len(parts) > 1 else 1.5,
                release_db_per_s=(float(parts[2]) if len(parts) > 2
                                  else 300.0)))
        except ValueError as e:
            raise SystemExit(f"--chain-limit: {e}")
    return Chain(*stages) if stages else None


def _apply_config_file(parser, argv) -> None:
    """Install JSON config values as parser *defaults* so explicitly passed
    command-line options always win (a plain post-parse override would
    silently beat the user's own flags)."""
    path = None
    for i, a in enumerate(argv):
        if a == "--config" and i + 1 < len(argv):
            path = argv[i + 1]
        elif a.startswith("--config="):
            path = a.split("=", 1)[1]
    if not path:
        return
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError("top level must be a JSON object")
        vals = {k: v for k, v in data.items() if k in _CONFIG_KEYS}
    except (OSError, ValueError) as err:
        # a broken --config must be a clean usage error, not a traceback
        # before argparse even runs
        print(f"error: cannot load --config {path}: {err}", file=sys.stderr)
        raise SystemExit(2)
    # append-action options (--chain-eq) would MERGE a config default with
    # explicit command-line values; when the user passed the flag, the
    # config's list must not contribute ("command line always wins")
    if any(a == "--chain-eq" or a.startswith("--chain-eq=") for a in argv):
        vals.pop("chain_eq", None)
    parser.set_defaults(**vals)


def _save_config(args) -> None:
    if not getattr(args, "save_config", None):
        return
    with open(args.save_config, "w") as f:
        json.dump({k: getattr(args, k) for k in _CONFIG_KEYS}, f, indent=1)
    print(f"settings saved -> {args.save_config}")


def _batch_cfg_from_args(args) -> ProcessingConfig:
    """The ONE ProcessingConfig construction for `process` and `watch`
    (identical option surfaces — a third copy had already drifted once)."""
    return ProcessingConfig(
        target_rate=args.rate,
        quality=args.quality,
        kind=args.kind,
        bits=args.bits,
        dither=not args.no_dither,
        remove_dc=not args.keep_dc,
        output_dir=args.out,
        postfix=args.postfix,
        output_format=args.output_format,
        keep_metadata=args.keep_metadata,
        reverb_mode=args.reverb,
        noise_floor_db=args.noise_floor,
        noise_floor_margin_pct=args.margin,
        require_input_rate=args.require_rate,
        batch_size=args.batch_size,
        gain_db=args.gain,
        normalize_lufs=args.normalize_lufs,
        normalize_tp_db=args.normalize_tp_db,
        surround_weights=getattr(args, "surround_weights", False),
        channel_routing=_parse_routing(args.routing),
        output_channels=args.channels,
        device_layout=args.device_layout,
        seed=None if args.seed == -1 else args.seed,
        latency_frames=getattr(args, "latency", None),
        chain=_build_chain(args),
    )


def cmd_process(args) -> int:
    files = _expand_inputs(args.inputs)
    if not files:
        print("error: no input files", file=sys.stderr)
        return 2
    cfg = _batch_cfg_from_args(args)
    _save_config(args)
    # --json promises machine-parseable stdout (the probe --json contract):
    # the human log moves to stderr so the ONLY stdout bytes are the summary
    log_out = sys.stderr if args.json else sys.stdout
    log = StatusLog(sink=lambda line: print(line, file=log_out, flush=True),
                    jsonl_path=args.log_jsonl)
    cal = CalibrationCache(os.path.join(args.out, ".calibration.json"))
    mesh = None
    if args.files_shards > 1 or args.channel_shards > 1:
        from .parallel import make_mesh

        mesh = make_mesh(num_files_shards=args.files_shards,
                         num_channel_shards=args.channel_shards)
    bp = BatchProcessor(cfg, log=log, calibration=cal, mesh=mesh)
    manifest_path = os.path.join(args.out, ".manifest.json") if args.resume else None
    os.makedirs(args.out, exist_ok=True)
    if args.profile:
        # jax.profiler trace of the whole batch (SURVEY.md section 5: the
        # profiling the reference lists as TODO, made first-class)
        import jax

        with jax.profiler.trace(args.profile):
            res = bp.run(files, manifest_path=manifest_path)
        print(f"profiler trace -> {args.profile}", file=log_out)
    else:
        res = bp.run(files, manifest_path=manifest_path)
    if args.json:
        print(json.dumps({
            "completed": res.completed,
            "skipped": res.skipped,
            "aborted": res.aborted,
            "failed": res.failed,
            "invalid_sample_rate": res.invalid,
            "audio_seconds_out": res.audio_seconds_out,
            "wall_seconds": res.wall_seconds,
            "x_realtime": res.x_realtime,
            "throughput": res.throughput,
            "per_file": res.per_file,
        }, indent=1))
    return 0 if (res.failed == 0 and res.invalid == 0) else 1


def cmd_preview(args) -> int:
    files = _expand_inputs(args.inputs)
    if not files:
        print("error: no input files", file=sys.stderr)
        return 2
    # --monitor enables the dual render (in bus mode the MAIN file is a
    # valid sink: the mixdown accumulates onto the monitoring channels);
    # --monitor-out implies it because writing the file requires the render
    want_monitor = args.monitor or bool(args.monitor_out)
    if args.monitor and not args.monitor_out and not args.target_channels:
        print("note: --monitor without --monitor-out has no sink in plain "
              "mode (no --target-channels); pass --monitor-out PATH",
              file=sys.stderr)
    try:
        mon_ch = tuple(int(c) for c in args.monitor_channels.split(","))
    except ValueError:
        print(f"error: --monitor-channels must be two integers, got "
              f"{args.monitor_channels!r}", file=sys.stderr)
        return 2
    if len(mon_ch) != 2:
        print(f"error: --monitor-channels needs exactly two channels, got "
              f"{args.monitor_channels!r}", file=sys.stderr)
        return 2
    try:
        target_ch = ([int(c) for c in args.target_channels.split(",")]
                     if args.target_channels else None)
    except ValueError:
        print(f"error: --target-channels must be integers, got "
              f"{args.target_channels!r}", file=sys.stderr)
        return 2
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)   # process/stream/watch all do
    stream_mode = bool(getattr(args, "stream", False))
    if not stream_mode:
        # auto-route hour-scale programmes to the constant-memory renderer:
        # the in-memory form would hold the whole playlist in host RAM
        # (~5.5 GB for an hour of looped 8-channel 48 k)
        from .pipeline.preview import projected_frames

        try:
            proj = projected_frames(files, args.rate,
                                    silence_ms=args.silence_ms,
                                    loops=args.loops)
            if proj * max(args.channels, 2) * 4 > (1 << 29):   # > 512 MB
                stream_mode = True
                print(f"note: projected programme of {proj} frames exceeds "
                      "the in-memory budget; using the streaming renderer",
                      file=sys.stderr)
        except Exception:
            pass     # unprobeable input: let the renderer raise properly
    try:
        if stream_mode:
            from .pipeline.preview import stream_playlist

            items, frames = stream_playlist(
                files, args.rate, args.out,
                silence_ms=args.silence_ms,
                output_channels=args.channels,
                monitor=want_monitor,
                monitor_out=args.monitor_out,
                loops=args.loops,
                target_channels=target_ch,
                monitor_channels=mon_ch,
                quality=getattr(args, "quality", "high"),
                kind=getattr(args, "kind", "sinc"),
            )
            print(f"rendered {len(items)} item(s), {frames} frames -> "
                  f"{args.out} (streamed)")
            if want_monitor and args.monitor_out:
                print(f"monitor mix -> {args.monitor_out}")
            for it in items:
                print(f"  @{it.start_frame:>10} {os.path.basename(it.path)} "
                      f"({it.num_frames} frames)")
            return 0
        main_mix, monitor, items = render_playlist(
            files, args.rate,
            silence_ms=args.silence_ms,
            output_channels=args.channels,
            monitor=want_monitor,
            loops=args.loops,
            target_channels=target_ch,
            monitor_channels=mon_ch,
            quality=getattr(args, "quality", "high"),
            kind=getattr(args, "kind", "sinc"),
        )
    except ValueError as err:
        # channel-placement validation (duplicate targets, out-of-bus
        # channels, monitor placement without bus mode): config errors,
        # not tracebacks
        print(f"error: {err}", file=sys.stderr)
        return 2
    wav.write_wav(args.out, main_mix, args.rate, bits=24)
    print(f"rendered {len(items)} item(s), {main_mix.shape[-1]} frames -> {args.out}")
    if monitor is not None and args.monitor_out:
        wav.write_wav(args.monitor_out, monitor, args.rate, bits=24)
        print(f"monitor mix -> {args.monitor_out}")
    for it in items:
        print(f"  @{it.start_frame:>10} {os.path.basename(it.path)} ({it.num_frames} frames)")
    return 0


def cmd_measure(args) -> int:
    from .pipeline.calibration import CAPTURE_FRAMES

    chain = _build_chain(args)
    chain_fn, capture, ringout = None, CAPTURE_FRAMES, 0
    if chain is not None:
        # measure the WHOLE loop — SRC + the user's insert chain — exactly
        # as the scheduler's auto-calibration does (the reference measures
        # the full hardware round trip, LatencyMeasurementService.swift:57)
        ringout = int(chain.tail_frames(args.rate))
        capture = max(CAPTURE_FRAMES,
                      -(-(3 * ringout + (1 << 15)) * args.rate_in
                        // args.rate))

        def chain_fn(x):
            from .ops.resample import resample_rates

            y = resample_rates(x, args.rate_in, args.rate,
                               quality=args.quality, kind=args.kind)
            return chain.apply(y, args.rate)

    res = measure_latency(args.rate_in, args.rate, quality=args.quality,
                          kind=args.kind, chain_fn=chain_fn,
                          capture_frames=capture, ringout_frames=ringout)
    status = "detected" if res.detected else "NOT DETECTED"
    what = f"SRC+chain({chain!r})" if chain is not None else "SRC"
    print(f"impulse {status} through {what}: latency {res.latency_frames} "
          f"frames @ {args.rate} Hz, "
          f"noise floor {res.noise_floor_db:.1f} dB, peak {res.peak_amplitude:.3f}")
    return 0 if res.detected else 1


def cmd_selftest(args) -> int:
    rep = run_loop_test(args.rate_in, args.rate, quality=args.quality,
                        kind=args.kind)
    print(f"{rep.verdict.value}: {rep.detail}")
    ok = rep.verdict.value == "loop_detected"
    if getattr(args, "parity", False):
        # numerical self-check: the device SRC vs the float64 host oracle on
        # fresh noise — catches a silently miscompiling/misbehaving device
        # (the deeper analogue of the reference's 1 kHz loop listen)
        from .models.oracle import resample_oracle
        from .ops.resample import resample_rates

        rng = np.random.default_rng(0)
        x = (0.25 * rng.standard_normal(args.rate_in // 2)).astype(np.float32)
        y = np.asarray(resample_rates(x, args.rate_in, args.rate,
                                      quality=args.quality, kind=args.kind))
        ref = resample_oracle(x, args.rate_in, args.rate,
                              quality=args.quality, kind=args.kind)
        err = y.astype(np.float64) - ref
        db = 20 * np.log10(np.sqrt((err**2).mean())
                           / np.sqrt((ref**2).mean()) + 1e-30)
        good = db <= -120.0
        print(f"parity: {db:.1f} dB RMS vs float64 oracle "
              f"[{'OK' if good else 'FAIL (target -120)'}]")
        ok = ok and good
    return 0 if ok else 1


def cmd_stream(args) -> int:
    from .pipeline.stream import stream_resample_file

    out_ext = os.path.splitext(args.out)[1].lower()
    if out_ext in (".ogg", ".oga", ".mp3", ".m4a"):
        print(f"error: lossy output format '{out_ext}' is not supported; "
              "deliverables are WAV/AIFF/FLAC (Ogg Vorbis is input-only)",
              file=sys.stderr)
        return 2
    cfg = ProcessingConfig(
        target_rate=args.rate,
        quality=args.quality,
        kind=args.kind,
        bits=args.bits,
        dither=not args.no_dither,
        remove_dc=not args.keep_dc,
        output_dir=os.path.dirname(os.path.abspath(args.out)) or ".",
        # explicit --format wins; otherwise the --out extension decides
        # (streaming WAV bytes into a .flac name helps nobody)
        output_format=(getattr(args, "output_format", None)
                       or {".aif": "aiff", ".aiff": "aiff",
                           ".flac": "flac"}.get(
                           os.path.splitext(args.out)[1].lower(), "wav")),
        keep_metadata=getattr(args, "keep_metadata", False),
        seed=None if args.seed == -1 else args.seed,
        gain_db=getattr(args, "gain", 0.0),
        normalize_lufs=getattr(args, "normalize_lufs", None),
        normalize_tp_db=getattr(args, "normalize_tp_db", None),
        surround_weights=getattr(args, "surround_weights", False),
        channel_routing=_parse_routing(getattr(args, "routing", None)),
        output_channels=getattr(args, "channels", None),
        reverb_mode=getattr(args, "reverb", False),
        noise_floor_db=getattr(args, "noise_floor", None),
        noise_floor_margin_pct=getattr(args, "margin", 10.0),
        chain=_build_chain(args),
    )
    # the batch path validates inside BatchProcessor; the streaming path has
    # no processor object, so validate here — otherwise CLI-exposed fields
    # (margin range, normalize_lufs sign, --normalize-tp without
    # --normalize-lufs, ...) would silently bypass the checks
    cfg.validate()
    last = [0]
    # --json: progress ticks move to stderr so stdout carries only the
    # summary document (same contract as process/probe --json)
    prog_out = sys.stderr if getattr(args, "json", False) else sys.stdout
    # --log-jsonl: the structured event journal process/watch already have
    # (no sink — the human stdout/stderr surface is unchanged)
    jlog = (StatusLog(jsonl_path=args.log_jsonl)
            if getattr(args, "log_jsonl", None) else None)

    def progress(p):
        pct = int(p * 100)
        if pct >= last[0] + 10:
            last[0] = pct
            print(f"  {pct}%", file=prog_out, flush=True)
            if jlog:
                jlog.append(f"progress {pct}%", event="progress",
                            input=args.input, pct=pct)

    os.makedirs(cfg.output_dir, exist_ok=True)
    mesh = None
    if args.frames_shards > 1:
        from .parallel import make_mesh

        mesh = make_mesh(num_files_shards=1,
                         num_frames_shards=args.frames_shards)
    if jlog:
        jlog.append(f"Streaming {args.input} -> {args.out}",
                    event="stream_start", input=args.input, output=args.out,
                    rate=args.rate, bits=cfg.bits, format=cfg.output_format)
    t0 = time.time()
    try:
        n = stream_resample_file(args.input, args.out, cfg,
                                 chunk_seconds=args.chunk_seconds,
                                 progress_cb=progress, mesh=mesh,
                                 latency_frames=getattr(args, "latency", None))
    except Exception as err:
        # log shippers need a terminal event for every stream_start; the
        # error still surfaces through the normal CLI-boundary handling
        if jlog:
            jlog.append(f"FAILED: {args.input}: {err}", event="failed",
                        input=args.input, output=args.out, error=str(err))
        raise
    if jlog:
        wall = time.time() - t0
        jlog.append(f"Completed: {args.out} ({n} frames @ {args.rate} Hz)",
                    event="completed", input=args.input, output=args.out,
                    out_frames=n, rate=args.rate,
                    seconds=round(n / args.rate, 3), wall_seconds=round(wall, 3),
                    x_realtime=round(n / args.rate / wall, 2) if wall > 0 else None)
    if getattr(args, "json", False):
        print(json.dumps({"input": args.input, "output": args.out,
                          "out_frames": n, "rate": args.rate,
                          "seconds": round(n / args.rate, 3),
                          "bits": cfg.bits,
                          "format": cfg.output_format}))
    else:
        print(f"wrote {n} frames @ {args.rate} Hz -> {args.out}")
    return 0


def cmd_watch(args) -> int:
    """Watch a folder and process files as they land — the production
    (serving) form of the reference's interactive drop-zone workflow
    (FileDropView/FileListAndLogComponent): drop files in, they come out
    resampled.  Polling, dependency-free: a file is picked up once its size
    is stable across two consecutive sweeps (a copy in progress keeps
    growing); the persistent manifest dedupes across sweeps and restarts,
    and the calibration cache is shared so the chain is measured once."""
    cfg = _batch_cfg_from_args(args)
    if args.interval <= 0:
        print("watch: --interval must be positive", file=sys.stderr)
        return 2
    if os.path.realpath(args.out) == os.path.realpath(args.dir):
        # outputs landing in the watched folder would be picked up and
        # reprocessed forever (x -> x_processed -> x_processed_processed...)
        print("watch: --out must differ from the watched folder",
              file=sys.stderr)
        return 2
    try:
        # fail at startup, not on the first drop hours later
        cfg.validate()
    except ValueError as err:
        print(f"watch: invalid config: {err}", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    mesh = None
    if args.files_shards > 1 or args.channel_shards > 1:
        # built once at startup (mesh errors fail the daemon immediately,
        # like cfg.validate above), shared by every sweep's batch
        from .parallel import make_mesh

        mesh = make_mesh(num_files_shards=args.files_shards,
                         num_channel_shards=args.channel_shards)
    # the sink prints every line; cap in-memory retention so a weeks-long
    # serving daemon doesn't grow without bound
    log = StatusLog(sink=lambda line: print(line, flush=True),
                    jsonl_path=args.log_jsonl, max_lines=1000)
    cal = CalibrationCache(os.path.join(args.out, ".calibration.json"))
    manifest_path = os.path.join(args.out, ".manifest.json")
    seen_sig: dict[str, tuple] = {}      # path -> (size, mtime) last sweep
    done_sig: dict[str, tuple] = {}      # path -> signature when processed
    sweeps = 0
    idle = 0.0

    log.append(f"watch: {args.dir} -> {args.out} (interval {args.interval}s)")
    while True:
        sweeps += 1
        try:
            names = sorted(os.listdir(args.dir))
        except OSError as err:
            if sweeps == 1:
                # a bad dir at startup is a config error: fail fast
                print(f"watch: cannot list {args.dir}: {err}", file=sys.stderr)
                return 2
            # mid-life listing blip (network mount, transient EMFILE): keep
            # serving, same containment as a processing failure
            log.append(f"watch sweep {sweeps}: cannot list {args.dir}: {err}")
            time.sleep(args.interval)
            continue
        # prune tracking for files removed from the folder (drop-zone
        # hygiene): a weeks-long daemon must not grow per-path state forever
        current = {os.path.join(args.dir, n) for n in names}
        for d in (seen_sig, done_sig):
            for stale in [p for p in d if p not in current]:
                del d[stale]
        ready = []
        changing = False          # some candidate is still being copied in
        for name in names:
            path = os.path.join(args.dir, name)
            if not codec.is_supported(name) or not os.path.isfile(path):
                continue
            try:
                st = os.stat(path)
                sig = (st.st_size, st.st_mtime_ns)
            except OSError:
                continue
            if done_sig.get(path) == sig:
                continue                 # already processed this content
            if seen_sig.get(path) == sig:        # stable across two sweeps
                ready.append(path)
            else:
                changing = True
            seen_sig[path] = sig
        if ready:
            # the cumulative manifest handles every case: new files process,
            # completed-and-unchanged files skip (size+mtime, then CRC),
            # RE-dropped files with new content reprocess (the manifest
            # stores the INPUT signature too) and overwrite the deliverable
            idle = 0.0
            try:
                bp = BatchProcessor(cfg, log=log, calibration=cal, mesh=mesh)
                res = bp.run(ready, manifest_path=manifest_path)
            except Exception as err:
                # keep serving: a transient device/compile failure recovers
                # on a later sweep (the files stay unmarked and retry); a
                # deterministic one shows up as a repeated, visible error
                log.append(f"watch sweep {sweeps} FAILED: {err}")
            else:
                if res.aborted:
                    # device dispatch failed mid-run (compile service outage):
                    # only verified completions are done; everything else
                    # stays unmarked and retries on a later sweep — without
                    # this, files dropped during an outage would be failed
                    # once and never retried for the daemon's lifetime
                    for p in ready:
                        if p in res.per_file:
                            done_sig[p] = seen_sig[p]
                    log.append(f"watch sweep {sweeps}: ABORTED "
                               f"({res.completed} completed, unprocessed "
                               f"files will retry)")
                else:
                    for p in ready:      # terminal either way; FAILED files
                        done_sig[p] = seen_sig[p]  # are per-file errors,
                        # deterministic — not retried
                    log.append(
                        f"watch sweep {sweeps}: {res.completed} completed"
                        + (f" ({res.skipped} resumed)" if res.skipped else "")
                        + f", {res.failed} failed")
        elif changing:
            idle = 0.0                   # a copy in progress is not idleness
        else:
            idle += args.interval
        if args.sweeps and sweeps >= args.sweeps:
            break
        if args.exit_after_idle and idle >= args.exit_after_idle:
            log.append(f"watch: idle {idle:.0f}s, exiting")
            break
        time.sleep(args.interval)
    return 0


def cmd_verify(args) -> int:
    """Audit a job manifest's completed outputs against their recorded size
    and CRC-32 — the standalone form of the resume-time content check
    (deliverable integrity for archives/transfers)."""
    from .pipeline.manifest import FileStatus, JobManifest, file_crc32

    try:
        m = JobManifest.load(args.manifest)
    except (OSError, ValueError, KeyError) as err:
        print(f"verify: cannot load manifest {args.manifest}: {err}",
              file=sys.stderr)
        return 2
    rows = []
    counts = {"ok": 0, "corrupt": 0, "missing": 0, "unverified": 0,
              "not_completed": 0}
    for e in m.entries():
        if e.status != FileStatus.COMPLETED:
            counts["not_completed"] += 1
            continue
        if not e.output_path or not os.path.exists(e.output_path):
            counts["missing"] += 1
            rows.append({"output": e.output_path, "source": e.path,
                         "status": "missing"})
            continue
        size_ok = (e.output_size is None
                   or os.path.getsize(e.output_path) == e.output_size)
        if not size_ok:
            counts["corrupt"] += 1
            rows.append({"output": e.output_path, "source": e.path,
                         "status": "size_mismatch"})
            continue
        if e.output_crc32 is None:
            counts["unverified"] += 1
            rows.append({"output": e.output_path, "source": e.path,
                         "status": "no_hash"})
            continue
        if file_crc32(e.output_path) == e.output_crc32:
            counts["ok"] += 1
            rows.append({"output": e.output_path, "source": e.path,
                         "status": "ok"})
        else:
            counts["corrupt"] += 1
            rows.append({"output": e.output_path, "source": e.path,
                         "status": "crc_mismatch"})
    if getattr(args, "json", False):
        print(json.dumps({"counts": counts, "files": rows}, indent=1))
    else:
        for r in rows:
            if r["status"] != "ok" or args.verbose:
                print(f"{r['status'].upper():14s} {r['output']}")
        print(f"verified: {counts['ok']} ok, {counts['corrupt']} corrupt, "
              f"{counts['missing']} missing, {counts['unverified']} "
              f"without hash, {counts['not_completed']} not completed")
    return 1 if (counts["corrupt"] or counts["missing"]) else 0


def cmd_devices(args) -> int:
    """Device enumeration — the accelerator analog of the reference's device scan
    (Source/MainComponent.cpp:338-376; Services/AudioService.swift:26-52)."""
    import jax

    devs = jax.devices()
    for d in devs:
        mem = ""
        try:
            stats = d.memory_stats()
            if stats and "bytes_limit" in stats:
                mem = f", {stats['bytes_limit'] / 2**30:.1f} GiB"
        except Exception:  # memory_stats unsupported on some backends
            pass
        print(f"[{d.id}] {d.device_kind} (platform {d.platform}{mem})")
    print(f"{len(devs)} device(s)")
    return 0


def cmd_probe(args) -> int:
    code = 0
    rows = []
    for f in _expand_inputs(args.inputs):
        try:
            info = codec.probe(f)
            loud = ""
            if getattr(args, "loudness", False):
                # r128_stats shares one SRC-to-48k + K-weighting pass between
                # the integrated and LRA statistics
                from .ops.loudness import (r128_stats, surround_weights,
                                           true_peak_db)

                x, r = codec.read_audio(f)
                w = (surround_weights(x.shape[0])
                     if getattr(args, "surround_weights", False) else None)
                lufs, lra = r128_stats(x, r, weights=w)
                tp = None
                if lufs <= -199.0:
                    loud = "  --.- LUFS (too short/silent)"
                else:
                    tp = float(true_peak_db(x, r))
                    loud = (f"  {lufs:.1f} LUFS, {tp:+.1f} dBTP, "
                            f"LRA {lra:.1f} LU")
        except Exception as e:
            # broad on purpose: with --loudness the metering block can fail
            # device-side (e.g. XlaRuntimeError on a pathological file) and
            # the contract is 'failed files become error rows, stdout stays
            # parseable' — one bad file must not abort the whole probe run
            if getattr(args, "json", False):
                rows.append({"path": f, "error": str(e)})
            else:
                print(f"{f}: ERROR {e}")
            code = 1
            continue
        valid = ("" if args.require_rate is None else
                 ("  [ok]" if info.is_valid_for_rate(args.require_rate)
                  else f"  [INVALID: need {args.require_rate} Hz]"))
        kind = "float" if info.is_float else "pcm"
        if getattr(args, "json", False):
            row = {"path": f, "container": info.container,
                   **({} if args.require_rate is None else
                      {"valid_for_rate":
                       info.is_valid_for_rate(args.require_rate)}),
                   "sample_rate": info.sample_rate,
                   "channels": info.num_channels,
                   "frames": info.num_frames,
                   "seconds": round(info.duration_seconds, 3),
                   "bit_depth": info.bit_depth, "is_float": info.is_float}
            if getattr(args, "loudness", False):
                row["lufs"] = None if lufs <= -199.0 else round(lufs, 2)
                if lufs > -199.0:
                    row["true_peak_db"] = round(tp, 2)
                    row["lra_lu"] = round(lra, 2)
            if getattr(args, "pairs", False):
                from .ops.routing import stereo_pairs

                row["stereo_pairs"] = [list(p) for p in
                                       stereo_pairs(info.num_channels)]
            rows.append(row)
        else:
            print(f"{f}: {info.container} {info.sample_rate} Hz, "
                  f"{info.num_channels} ch, {info.num_frames} frames "
                  f"({info.duration_seconds:.3f} s), {info.bit_depth}-bit {kind}"
                  f"{valid}{loud}")
            if getattr(args, "pairs", False):
                # the reference's stereo-pair picker enumeration
                # (Source/AppState.h:328-373; AudioDevice.swift:33-44);
                # 0-indexed so entries paste directly into --routing
                from .ops.routing import stereo_pairs

                pairs = stereo_pairs(info.num_channels)
                txt = (", ".join(f"{a}-{b}" for a, b in pairs)
                       if pairs else "(none: fewer than 2 channels)")
                print(f"  stereo pairs (0-indexed): {txt}")
    if getattr(args, "json", False):
        print(json.dumps(rows, indent=1))
    return code


def main(argv: list[str] | None = None) -> int:
    from .utils.compilecache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(
        prog="f9tpu",
        allow_abbrev=False,   # the --config pre-scan and --chain-eq merge
        # suppression match literal flag spellings; a silently-accepted
        # abbreviation (--conf) would bypass them
        description="Accelerator-native batch audio resampler "
                    "(capabilities of F9 JUCE Batch Resampler Studio)",
    )
    from .version import __version__

    ap.add_argument("--version", action="version",
                    version=f"f9tpu {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _add_batch_args(p) -> None:
        """Options shared verbatim by `process` and `watch` (the watch loop
        is the serving form of a batch run and takes the full surface)."""
        p.add_argument("--out", required=True,
                       help="output directory (mandatory)")
        p.add_argument("--log-jsonl", default=None, metavar="PATH",
                       help="append every status-log event to PATH as one "
                            "JSON object per line (structured twin of the "
                            "human log; survives --json, watch restarts)")
        _add_common_src_args(p)
        p.add_argument("--bits", type=int, default=24, choices=[16, 24, 32])
        p.add_argument("--latency", type=int, default=None,
                       help="known chain/system delay in output frames: "
                            "skip auto-calibration and trim exactly this "
                            "(negative = acausal, compensated with a zero "
                            "head)")
        p.add_argument("--postfix", default="_processed")
        p.add_argument("--keep-metadata", action="store_true",
                       help="carry metadata chunks into same-container "
                            "outputs (WAV bext/LIST/cue/smpl/iXML; AIFF "
                            "NAME/MARK/INST), sample positions rescaled to "
                            "the output rate")
        p.add_argument("--format", dest="output_format", default="wav",
                       choices=["wav", "aiff", "flac"],
                       help="output container (wav = reference behaviour)")
        p.add_argument("--no-dither", action="store_true")
        p.add_argument("--keep-dc", action="store_true",
                       help="skip DC offset removal")
        p.add_argument("--gain", type=float, default=0.0, help="gain dB")
        p.add_argument("--normalize-lufs", type=float, default=None,
                       metavar="TARGET",
                       help="loudness-normalize each file to TARGET "
                            "integrated LUFS (BS.1770-4, measured on the "
                            "source; negative value needs the = form: "
                            "--normalize-lufs=-14)")
        p.add_argument("--normalize-tp", dest="normalize_tp_db", type=float,
                       default=None, metavar="CEILING",
                       help="with --normalize-lufs: cap gains so the true "
                            "peak stays <= CEILING dBTP (= form for "
                            "negatives)")
        p.add_argument("--surround-weights", action="store_true",
                       help="meter 6/8-channel files with BS.1770-4 5.1/7.1 "
                            "channel weights (surrounds 1.41, LFE excluded) "
                            "instead of treating them as discrete buses")
        p.add_argument("--reverb", action="store_true",
                       help="reverb mode: keep tails until below noise floor")
        p.add_argument("--noise-floor", type=float, default=None,
                       help="measured noise floor dB (default: -80 fallback)")
        p.add_argument("--margin", type=float, default=10.0,
                       help="noise floor margin %% (0-50)")
        p.add_argument("--require-rate", type=int, default=None,
                       help="strict mode: reject inputs not at this rate")
        p.add_argument("--batch-size", type=int, default=8)
        p.add_argument("--device-layout", default="packed",
                       choices=["packed", "rows"],
                       help="packed: fewest host<->device bytes; rows: "
                            "fewest device-side relayouts (trade-off not "
                            "yet re-measured on the GPU)")
        p.add_argument("--routing", default=None,
                       help="MCFX channel routing map, e.g. '0,1,-1,2' "
                            "(out[i] <- in[map[i]], -1 = silence)")
        p.add_argument("--channels", type=int, default=None,
                       help="fan mono inputs out to N channels")
        p.add_argument("--seed", type=int, default=0,
                       help="dither seed (per-file keys derive from "
                            "seed+path; same seed = byte-identical reruns; "
                            "-1 = wall clock)")
        _add_chain_args(p)

    def _add_chain_args(p) -> None:
        p.add_argument("--chain-ir", default=None,
                       help="insert chain: convolution reverb "
                            "impulse-response WAV (mono or matching channel "
                            "count)")
        p.add_argument("--chain-wet", type=float, default=1.0,
                       help="reverb wet level (with --chain-ir)")
        p.add_argument("--chain-dry", type=float, default=0.0,
                       help="reverb dry level (with --chain-ir)")
        p.add_argument("--chain-fir", default=None,
                       help="insert chain: FIR taps WAV (first channel)")
        p.add_argument("--chain-delay-ms", type=float, default=0.0,
                       help="insert chain: pure delay in ms (calibration "
                            "measures and trims it)")
        p.add_argument("--chain-comp", default=None,
                       metavar="THRESH:RATIO[:ATTACK_MS[:RELEASE_DBS"
                               "[:MAKEUP]]]",
                       help="insert chain: bus compressor (instant attack, "
                            "linear-dB release; channel-linked). Negative "
                            "threshold needs the = form: --chain-comp=-18:4")
        p.add_argument("--chain-sat", default=None,
                       metavar="KIND:DRIVE_DB[:MIX]",
                       help="insert chain: saturator (tanh/soft/hard "
                            "waveshaper)")
        p.add_argument("--chain-width", type=float, default=None,
                       help="insert chain: stereo M/S width (0=mono, "
                            "1=as-is, 2=wide)")
        p.add_argument("--chain-eq", action="append", default=None,
                       metavar="KIND:FREQ[:Q[:GAIN_DB]]",
                       help="insert chain: biquad EQ section (lowpass/"
                            "highpass/peaking/lowshelf/highshelf); "
                            "repeatable, applied in order")
        p.add_argument("--chain-gate", default=None,
                       metavar="THRESH:RATIO[:RELEASE_DBS[:RANGE_DB"
                               "[:ATTACK_MS]]]",
                       help="insert chain: downward expander / gate "
                            "(channel-linked; the release doubles as hold). "
                            "Negative threshold needs the = form: "
                            "--chain-gate=-50:3")
        p.add_argument("--chain-limit", default=None,
                       metavar="CEILING_DB[:LOOKAHEAD_MS[:RELEASE_DBS]]",
                       help="insert chain: lookahead brickwall limiter "
                            "(applied last; its lookahead delay is "
                            "measured by calibration and trimmed). "
                            "Negative ceiling needs the = form: "
                            "--chain-limit=-0.3")

    p = sub.add_parser("process", help="batch resample files")
    process_parser = p
    p.add_argument("inputs", nargs="+", help="files, globs or directories")
    _add_batch_args(p)
    p.add_argument("--files-shards", type=int, default=1,
                   help="shard batches over N chips on the files axis (DP)")
    p.add_argument("--channel-shards", type=int, default=1,
                   help="shard MCFX buses over N chips on the channels axis")
    p.add_argument("--resume", action="store_true",
                   help="persist a manifest and skip already-completed files")
    p.add_argument("--json", action="store_true", help="print summary JSON")
    p.add_argument("--config", default=None, help="load settings JSON")
    p.add_argument("--save-config", default=None, help="save resolved settings JSON")
    p.add_argument("--profile", default=None,
                   help="write a jax.profiler trace of the batch to this dir")
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("stream", help="constant-memory resample of one long file")
    p.add_argument("input")
    p.add_argument("--out", required=True, help="output WAV/AIFF/FLAC path")
    p.add_argument("--log-jsonl", default=None, metavar="PATH",
                   help="append stream_start/progress/completed events to "
                        "PATH as one JSON object per line (the structured "
                        "journal process/watch have)")
    _add_common_src_args(p)
    p.add_argument("--bits", type=int, default=24, choices=[16, 24, 32])
    p.add_argument("--format", dest="output_format", default=None,
                   choices=["wav", "aiff", "flac"],
                   help="output container (default: inferred from the "
                        "--out extension, else wav)")
    p.add_argument("--keep-metadata", action="store_true",
                   help="carry bext/LIST/cue metadata (WAV outputs)")
    p.add_argument("--seed", type=int, default=0,
                   help="dither seed (-1 = wall clock, non-reproducible)")
    p.add_argument("--no-dither", action="store_true")
    p.add_argument("--keep-dc", action="store_true")
    p.add_argument("--gain", type=float, default=0.0, help="gain dB")
    p.add_argument("--normalize-lufs", type=float, default=None,
                   help="loudness-normalize to TARGET integrated LUFS "
                        "(two-pass: chunk-exact metering pre-pass, then the "
                        "normal constant-memory write; negative value needs "
                        "the = form: --normalize-lufs=-14)")
    p.add_argument("--normalize-tp", dest="normalize_tp_db", type=float,
                   default=None,
                   help="with --normalize-lufs: cap the gain so the source "
                        "true peak stays at/below this dBTP")
    p.add_argument("--surround-weights", action="store_true",
                   help="meter 6/8-channel files with BS.1770-4 5.1/7.1 "
                        "channel weights (surrounds 1.41, LFE excluded)")
    p.add_argument("--routing", default=None,
                   help="channel routing map, e.g. '0,1,-1,2' "
                        "(-1 = silent output channel)")
    p.add_argument("--channels", type=int, default=None,
                   help="fan a mono input out to N channels")
    p.add_argument("--latency", type=int, default=None,
                   help="trim this many output frames of known chain/system "
                        "delay from the head (single-chip)")
    p.add_argument("--reverb", action="store_true",
                   help="keep the (chain) tail past the source until it "
                        "falls below the noise floor — unlike the batch "
                        "path, the INPUT length is unbounded here; only the "
                        "tail is capped (single-chip)")
    p.add_argument("--chain-ir", default=None,
                   help="insert chain: convolution reverb impulse-response "
                        "WAV (FIR-type chains stream exactly)")
    p.add_argument("--chain-wet", type=float, default=1.0)
    p.add_argument("--chain-dry", type=float, default=0.0)
    p.add_argument("--chain-fir", default=None,
                   help="insert chain: FIR taps WAV (first channel)")
    p.add_argument("--chain-delay-ms", type=float, default=0.0,
                   help="insert chain: pure delay in ms (pair with "
                        "--latency to trim it)")
    p.add_argument("--chain-eq", action="append", default=None,
                   metavar="KIND:FREQ[:Q[:GAIN_DB]]",
                   help="insert chain: biquad EQ section; repeatable")
    p.add_argument("--noise-floor", type=float, default=None,
                   help="tail threshold base in dB (default -80 fallback)")
    p.add_argument("--margin", type=float, default=10.0,
                   help="noise-floor margin percent for the tail threshold")
    p.add_argument("--chunk-seconds", type=float, default=20.0)
    p.add_argument("--frames-shards", type=int, default=1,
                   help="shard each device step's frames axis over N chips "
                        "(one huge file across the mesh)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable result on stdout")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("watch",
                       help="watch a folder, process files as they land "
                            "(the drop-zone workflow, headless)")
    p.add_argument("dir", help="input folder to watch")
    _add_batch_args(p)
    p.add_argument("--files-shards", type=int, default=1,
                   help="shard batches over N chips on the files axis (DP)")
    p.add_argument("--channel-shards", type=int, default=1,
                   help="shard MCFX buses over N chips on the channels axis")
    p.add_argument("--interval", type=float, default=2.0,
                   help="sweep interval seconds")
    p.add_argument("--sweeps", type=int, default=0,
                   help="stop after N sweeps (0 = run until killed)")
    p.add_argument("--exit-after-idle", type=float, default=0.0,
                   help="stop after this many idle seconds (0 = never)")
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser("verify",
                       help="audit a manifest's outputs (size + CRC-32)")
    p.add_argument("manifest", help="job manifest JSON (process --resume)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--verbose", action="store_true",
                   help="also list files that verified ok")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("devices", help="list compute devices")
    p.set_defaults(fn=cmd_devices)

    p = sub.add_parser("preview", help="render a gapless playlist")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--out", required=True, help="output WAV path")
    p.add_argument("--rate", type=int, default=48000)
    p.add_argument("--quality", default="high",
                   choices=["low", "medium", "high", "ultra"],
                   help="SRC preset for mixed-rate items")
    p.add_argument("--kind", default="sinc",
                   choices=["sinc", "minphase", "lagrange"])
    p.add_argument("--silence-ms", type=int, default=150)
    p.add_argument("--channels", type=int, default=2)
    p.add_argument("--monitor", action="store_true")
    p.add_argument("--monitor-out", default=None)
    p.add_argument("--loops", type=int, default=1,
                   help="render the playlist N times (wrap-around looping)")
    p.add_argument("--target-channels", default=None,
                   help="render into these bus channels, e.g. '4,5' "
                        "(others stay silent)")
    p.add_argument("--monitor-channels", default="0,1",
                   help="bus channels carrying the monitor mix (dual render)")
    p.add_argument("--stream", action="store_true",
                   help="constant-memory renderer (one item at a time; "
                        "auto-selected for hour-scale programmes)")
    p.set_defaults(fn=cmd_preview)

    p = sub.add_parser("measure", help="measure chain latency (impulse test)")
    p.add_argument("--rate-in", type=int, default=44100)
    _add_common_src_args(p)
    _add_chain_args(p)   # measure the WHOLE loop: SRC + the user's chain
    p.set_defaults(fn=cmd_measure)

    p = sub.add_parser("selftest", help="device loop test (1 kHz tone)")
    p.add_argument("--rate-in", type=int, default=48000)
    p.add_argument("--parity", action="store_true",
                   help="also verify device SRC parity vs the float64 "
                        "oracle (<= -120 dB)")
    _add_common_src_args(p)
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser("probe", help="print file metadata")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--require-rate", type=int, default=None)
    p.add_argument("--loudness", action="store_true",
                   help="also measure BS.1770-4 integrated loudness (LUFS) "
                        "on device")
    p.add_argument("--surround-weights", action="store_true",
                   help="with --loudness: apply BS.1770-4 5.1/7.1 channel "
                        "weights to 6/8-channel files")
    p.add_argument("--pairs", action="store_true",
                   help="list each file's odd/even stereo pairs (the "
                        "reference's pair-picker enumeration; 0-indexed, "
                        "pasteable into --routing)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (one list of objects)")
    p.set_defaults(fn=cmd_probe)

    # config defaults go on the *process subparser* (its own defaults would
    # otherwise shadow anything set on the top-level parser)
    _apply_config_file(process_parser, list(argv) if argv is not None else sys.argv[1:])
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except ValueError as err:
        # the CLI boundary: config/validation errors (cfg.validate(),
        # mesh shape checks, per-file bound checks raised before any work)
        # are usage errors, not tracebacks
        print(f"error: {err}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
