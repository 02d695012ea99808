"""Benchmark: audio-minutes resampled per second per chip (44.1->48 kHz stereo).

Headline = the fused device graph (SRC + tail windows + DC removal + TPDF
dither + 24-bit quantize) on resident data — the replacement for the
reference's ~1.06x-real-time hardware loop (BASELINE.md).  Baseline target:
1000x real time per chip = 16.667 audio-min/s.  Accuracy: RMS error of the
emitted 24-bit codes vs the float64 oracle (the JUCE-oracle role,
BASELINE.json).

Needs an NVIDIA GPU and fails without one.  Timing uses
`f9tpu.utils.benchtime.measure_op`: host clock around ``block_until_ready``
after a warm-up call.  Every accuracy gate and both end-to-end phases must
pass, or the script exits non-zero.

Prints the card's ``name, power.limit`` and the JAX device on stderr, then
ONE JSON line:
  {"metric": ..., "value": N, "unit": "audio-min/s", "vs_baseline": N, ...}
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp



def main() -> None:
    from f9tpu.config import ProcessingConfig
    from f9tpu.models.oracle import resample_oracle
    from f9tpu.pipeline.graph import _cfg_key, _process_impl_rows
    from f9tpu.utils.benchtime import measure_op
    from f9tpu.utils.compilecache import enable_compile_cache
    from f9tpu.utils.device import card_lines, require_gpu

    devs = require_gpu("bench.py")
    enable_compile_cache()
    dev = devs[0]
    cards = card_lines()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(devs), "cards": cards}
    print(f"bench device: {device}", file=sys.stderr)

    from f9tpu.models.filters import design_cycle_bank
    from f9tpu.ops.resample import rows_marshal_plan

    rate_in, rate_out = 44100, 48000
    files, channels, frames = 16, 2, 1 << 20     # ~23.8 s per file
    cfg = ProcessingConfig(output_dir="/tmp/bench_out", target_rate=rate_out,
                           quality="high")
    cfg_key = _cfg_key(cfg, 0)
    valid = jnp.full((files,), frames, jnp.int32)
    key = jax.random.PRNGKey(0)

    def step(x):
        # the rows fast path: host-marshalled rows in, rows codes out
        return _process_impl_rows(
            x, valid, key, rate_in=rate_in, rate_out=rate_out, cfg_key=cfg_key,
        )

    bank = design_cycle_bank(rate_in, rate_out, quality=cfg.quality)
    n_rows, pf = rows_marshal_plan(bank, frames)
    xf = np.asarray(
        jax.random.normal(key, (files, channels, frames), jnp.float32)) * 0.25
    xb = np.zeros((files, channels, n_rows * bank.M), np.float32)
    xb[:, :, pf : pf + frames] = xf
    x = jnp.asarray(xb.reshape(files, channels, n_rows, bank.M))

    wall = measure_op(step, x, n=8, repeats=3)

    audio_seconds = files * frames / rate_in
    x_rt = audio_seconds / wall
    audio_min_per_s = x_rt / 60.0
    print(f"device step: {wall*1000:.2f} ms for {audio_seconds:.1f} s audio "
          f"-> {x_rt:.0f}x real time", file=sys.stderr)

    # ---- accuracy vs float64 oracle: multiple graph variants, all gated at
    # the -120 dB target (BASELINE.md) so the driver artifact certifies more
    # than the headline path ----
    rng = np.random.default_rng(0)
    n_acc = 1 << 15
    # headroom matters: resampling white noise overshoots its sample peaks
    # (Gibbs), and the 24-bit quantizer clips at full scale — keep peaks ~0.5
    xa_h = (0.125 * rng.standard_normal((1, 1, n_acc))).astype(np.float32)

    def rows_case(r_in, r_out):
        # feed the HOST-MARSHALLED 4-D rows form — the exact branch the
        # headline times and the scheduler ships in production; 3-D input
        # would fall into the separate conv implementation and the artifact
        # would certify a path it never measures
        acc_cfg = ProcessingConfig(output_dir="/tmp/bench_out",
                                   target_rate=r_out, quality="high",
                                   dither=False, remove_dc=False)
        bank_c = design_cycle_bank(r_in, r_out, quality="high")
        n_r, pf_r = rows_marshal_plan(bank_c, n_acc)
        xb_c = np.zeros((1, 1, n_r * bank_c.M), np.float32)
        xb_c[:, :, pf_r: pf_r + n_acc] = xa_h
        res = _process_impl_rows(
            jax.device_put(
                jnp.asarray(xb_c.reshape(1, 1, n_r, bank_c.M)), dev),
            jnp.full((1,), n_acc, jnp.int32),
            jax.random.PRNGKey(1),
            rate_in=r_in, rate_out=r_out, cfg_key=_cfg_key(acc_cfg, 0),
        )
        codes, out_frames = np.asarray(res[0]), int(np.asarray(res[1])[0])
        codes = codes.reshape(1, codes.shape[1], -1)   # host flatten (free)
        got = codes[0, 0, :out_frames].astype(np.float64) / (1 << 23)
        ref = resample_oracle(xa_h[0, 0], r_in, r_out, quality="high")
        err = got - ref[:out_frames]
        return 20 * np.log10(np.sqrt((err**2).mean())
                             / np.sqrt((ref**2).mean()) + 1e-30)

    def raw_packed_case(r_in, r_out):
        # on-device codec both ways: 24-bit PCM bytes up, packed payload down
        from f9tpu.pipeline.graph import process_batch_raw

        acc_cfg = ProcessingConfig(output_dir="/tmp/bench_out",
                                   target_rate=r_out, quality="high",
                                   dither=False, remove_dc=False)
        q = np.clip(np.round(xa_h[0] * (1 << 23)), -(1 << 23),
                    (1 << 23) - 1).astype(np.int64)
        inter = q.T.reshape(-1)                       # mono: frames order
        b = np.zeros(len(inter) * 3, np.uint8)
        u = (inter & 0xFFFFFF).astype(np.uint32)
        b[0::3] = u & 0xFF
        b[1::3] = (u >> 8) & 0xFF
        b[2::3] = (u >> 16) & 0xFF
        res = process_batch_raw(
            jax.device_put(jnp.asarray(b[None])), np.array([n_acc], np.int32),
            acc_cfg, r_in, jax.random.PRNGKey(2), in_channels=1, in_bits=24)
        payload = np.asarray(res.codes)[0]
        out_frames = int(np.asarray(res.out_frames)[0])
        pb = payload[: out_frames * 3].astype(np.int64)
        vals = pb[0::3] | (pb[1::3] << 8) | (pb[2::3] << 16)
        vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
        got = vals.astype(np.float64) / (1 << 23)
        ref = resample_oracle(q[0].astype(np.float64) / (1 << 23), r_in,
                              r_out, quality="high")
        err = got - ref[:out_frames]
        return 20 * np.log10(np.sqrt((err**2).mean())
                             / np.sqrt((ref**2).mean()) + 1e-30)

    def graph_case(r_in, r_out, quality, kind="sinc"):
        # the scheduler's own dispatch for this pair/preset: rows fast path
        # when applicable, else the flat conv graph — certifies whatever a
        # production run would actually execute
        from f9tpu.ops.resample import rows_pre_applicable

        bank_c = design_cycle_bank(r_in, r_out, quality=quality, kind=kind)
        acc_cfg = ProcessingConfig(output_dir="/tmp/bench_out",
                                   target_rate=r_out, quality=quality,
                                   kind=kind, dither=False, remove_dc=False)
        from f9tpu.pipeline.graph import process_batch

        res = process_batch(
            jax.device_put(jnp.asarray(xa_h), dev),
            jnp.full((1,), n_acc, jnp.int32), acc_cfg, r_in,
            jax.random.PRNGKey(1),
            rows_layout=rows_pre_applicable(bank_c))
        codes = np.asarray(res.codes)
        out_frames = int(np.asarray(res.out_frames)[0])
        codes = codes.reshape(1, codes.shape[1], -1)
        got = codes[0, 0, :out_frames].astype(np.float64) / (1 << 23)
        ref = resample_oracle(xa_h[0, 0], r_in, r_out, quality=quality,
                              kind=kind)
        err = got - ref[:out_frames]
        return 20 * np.log10(np.sqrt((err**2).mean())
                             / np.sqrt((ref**2).mean()) + 1e-30)

    gates = {
        "up_44k_to_48k_rows": rows_case(44100, 48000),
        "down_96k_to_44k_rows": rows_case(96000, 44100),
        "raw24_packed_44k_to_48k": raw_packed_case(44100, 48000),
        # the JUCE-equivalent preset: "ultra" = 100 zero-crossings =
        # WindowedSincInterpolator (BASELINE.json oracle; models/filters.py)
        "ultra_44k_to_48k": graph_case(44100, 48000, "ultra"),
        # a 176.4 kHz pair (the last supported rate family uncovered by the
        # driver artifact through round 2)
        "down_176k_to_48k": graph_case(176400, 48000, "high"),
        # round 3's minimum-phase kind (real-cepstrum causal bank, no
        # pre-ringing): certify it in the surviving artifact too
        "minphase_44k_to_48k": graph_case(44100, 48000, "high",
                                          kind="minphase"),
    }
    for name, db in gates.items():
        status = "OK" if db <= -120.0 else "FAIL"
        print(f"accuracy[{name}]: {db:.1f} dB RMS vs float64 oracle [{status}]",
              file=sys.stderr)
    rms_db = gates["up_44k_to_48k_rows"]
    # `not (db <= -120)` so a NaN (degraded device) FAILS the gate — the
    # naive `db > -120` is False for NaN and would certify garbage
    if any(not (db <= -120.0) for db in gates.values()):
        print("ACCURACY GATE FAILED (target -120 dB)", file=sys.stderr)
        sys.exit(1)

    # ---- varispeed (NTSC pull-down 44.1k->44.056k): the banded path.
    # Headline = the host-marshalled cycle-rows form (the scheduler's rows
    # fast path: overlapping rows arrive from the host as strided memcpys).
    # The device-resident flat form (the streaming path's shape) is reported
    # alongside; both trace the same `_banded_eval_rows`, so their floats are
    # bitwise identical and ONE oracle gate certifies both. ----
    from f9tpu.ops.resample import (banded_rows_plan, marshal_banded_rows,
                                    resample_banded,
                                    resample_banded_rows_pre)

    vs_bank = design_cycle_bank(44100, 44056, quality="high")
    n_rows_v, w_row_v, pf_v = banded_rows_plan(vs_bank, frames)
    total_v = (n_rows_v - 1) * vs_bank.M + w_row_v
    flat_v = np.zeros((files, channels, total_v), np.float32)
    flat_v[:, :, pf_v: pf_v + frames] = xf
    xv_rows = jnp.asarray(marshal_banded_rows(flat_v, vs_bank))
    wv = measure_op(lambda xx: resample_banded_rows_pre(xx, vs_bank),
                    xv_rows, n=8, repeats=3)
    vs_x_rt = (files * frames / 44100) / wv
    wv_flat = measure_op(lambda xx: resample_banded(xx, vs_bank),
                         jnp.asarray(xf), n=8, repeats=3)
    vs_flat_x_rt = (files * frames / 44100) / wv_flat
    xa_vs = xa_h[0]
    got_vs = np.asarray(resample_banded(jnp.asarray(xa_vs), vs_bank))
    ref_vs = resample_oracle(xa_vs.astype(np.float64), 44100, 44056,
                             quality="high")
    err_vs = got_vs - ref_vs
    vs_db = 20 * np.log10(np.sqrt((err_vs**2).mean())
                          / np.sqrt((ref_vs**2).mean()) + 1e-30)
    print(f"varispeed 44.1k->44.056k (banded rows): {wv*1000:.2f} ms -> "
          f"{vs_x_rt:.0f}x RT (flat form {wv_flat*1000:.2f} ms -> "
          f"{vs_flat_x_rt:.0f}x), {vs_db:.1f} dB vs oracle", file=sys.stderr)
    if not (vs_db <= -120.0):     # NaN-proof (see the gate loop above)
        print("VARISPEED ACCURACY GATE FAILED", file=sys.stderr)
        sys.exit(1)

    # ---- end-to-end (files in -> files out) through the persistent host
    # pipeline: decode threads -> device -> encode threads ----
    import shutil
    import tempfile

    from f9tpu.config import ProcessingConfig as _PC
    from f9tpu.io import write_wav
    from f9tpu.pipeline import BatchProcessor

    d = tempfile.mkdtemp(prefix="f9bench_e2e_")
    rng2 = np.random.default_rng(1)
    # 20 s files land in the 1<<20 bucket — the same shape class as the
    # headline
    n_files, e2e_frames = 12, 20 * 44100         # 12 x 20 s stereo
    paths = []
    for i in range(n_files):
        p = f"{d}/in_{i}.wav"
        write_wav(p, (0.25 * rng2.standard_normal(
            (2, e2e_frames))).astype(np.float32), 44100, bits=24)
        paths.append(p)
    # batch_size 4 -> three flushes: decode/H2D of flush N+1 and D2H/
    # encode of flush N-1 overlap flush N's compute (the persistent
    # pipeline)
    e2e_cfg = _PC(output_dir=f"{d}/out", target_rate=48000,
                  quality="high", seed=0, batch_size=4)
    # shared calibration between warm and timed runs: the production
    # CLI persists it to <out>/.calibration.json (cli.py:299), so the
    # steady-state serving number must not re-pay the measurement
    from f9tpu.pipeline.calibration import CalibrationCache as _CC

    e2e_cal = _CC()
    BatchProcessor(e2e_cfg, calibration=e2e_cal).run(paths)  # warm
    t0 = time.time()
    bp = BatchProcessor(e2e_cfg, calibration=e2e_cal)
    r = bp.run(paths)
    e2e_wall = time.time() - t0
    if r.failed or r.completed < n_files:
        # a contained device outage returns normally with files FAILED;
        # a wall over partial work would inflate the metric
        raise RuntimeError(
            f"e2e incomplete: {r.completed}/{n_files} completed")
    e2e_x_rt = (n_files * e2e_frames / 44100) / e2e_wall
    print(f"e2e files->files: {e2e_wall:.2f}s for "
          f"{n_files * e2e_frames / 44100:.0f}s audio -> "
          f"{e2e_x_rt:.0f}x RT ({r.completed} completed)",
          file=sys.stderr)
    # per-stage x-realtime so the artifact shows WHERE the wall went
    e2e_stages = {k: round(v["x_realtime"], 1)
                  for k, v in bp.throughput.summary().items()}
    print(f"e2e per-stage x-realtime: {e2e_stages}", file=sys.stderr)
    shutil.rmtree(d, ignore_errors=True)

    # ---- mixed-rate e2e: a 10-file 3-rate mini-library (the studio-library
    # shape, BASELINE.json config 5).  Each rate group pays its own
    # calibration and dispatch: a fixed-cost profile.  Timed warm. ----
    d = tempfile.mkdtemp(prefix="f9bench_mixed_")
    rng3 = np.random.default_rng(2)
    lib_rates = [44100, 88200, 96000, 44100, 88200,
                 96000, 44100, 88200, 96000, 44100]
    paths = []
    secs = 4.0
    audio_s = 0.0
    for i, r in enumerate(lib_rates):
        p = f"{d}/mix_{i}_{r}.wav"
        nfr = int(secs * r)
        write_wav(p, (0.25 * rng3.standard_normal(
            (2, nfr))).astype(np.float32), r, bits=24)
        paths.append(p)
        audio_s += secs
    mixed_cfg = _PC(output_dir=f"{d}/out", target_rate=48000,
                    quality="high", seed=0, batch_size=4)
    mixed_cal = _CC()                           # see e2e_cal above
    BatchProcessor(mixed_cfg, calibration=mixed_cal).run(paths)  # warm
    t0 = time.time()
    r = BatchProcessor(mixed_cfg, calibration=mixed_cal).run(paths)
    mixed_wall = time.time() - t0
    if r.failed or r.completed < len(paths):
        raise RuntimeError(
            f"mixed e2e incomplete: {r.completed}/{len(paths)}")
    e2e_mixed_x_rt = audio_s / mixed_wall
    print(f"e2e mixed-rate library: {mixed_wall:.2f}s for {audio_s:.0f}s "
          f"audio over {len(set(lib_rates))} rate groups -> "
          f"{e2e_mixed_x_rt:.0f}x RT", file=sys.stderr)
    shutil.rmtree(d, ignore_errors=True)

    baseline_x_rt = 1000.0  # north-star: 1000x real time per chip

    def _num(v, nd=1):
        # bare NaN/Inf are invalid JSON tokens; the one-line artifact
        # contract requires strict-parseable output
        f = float(v)
        return round(f, nd) if np.isfinite(f) else None

    print(json.dumps({
        "metric": "audio-minutes resampled/sec/chip (44.1->48k stereo)",
        "value": _num(audio_min_per_s, 3),
        "unit": "audio-min/s",
        "vs_baseline": _num(x_rt / baseline_x_rt, 3),
        "x_realtime": _num(x_rt),
        "accuracy_rms_db_vs_oracle": _num(rms_db),
        "accuracy_gates_db": {k: _num(v) for k, v in gates.items()},
        "varispeed_x_realtime": _num(vs_x_rt),
        "varispeed_flat_x_realtime": _num(vs_flat_x_rt),
        "varispeed_rms_db": _num(vs_db),
        "e2e_x_realtime": _num(e2e_x_rt),
        "e2e_stage_x_realtime": e2e_stages,
        "e2e_mixed_x_realtime": _num(e2e_mixed_x_rt),
        "device": device,
    }))


if __name__ == "__main__":
    main()
