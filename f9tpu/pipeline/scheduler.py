"""Batch scheduler: the throughput-oriented replacement for the app's
message-thread batch driver.

The reference drives a batch as: load next file -> run the RT loop -> poll a
30 Hz timer -> save -> sleep the inter-file gap -> next
(Source/MainComponent.cpp:174-313,581-621; AudioProcessingService.swift:65-113).
Throughput is 1x real time because the "processing" is physical playback.

Here the pipeline is: decode threads -> bucketed fixed-shape batches -> one
fused device graph -> encode threads, with all three stages overlapped via
queues (the double-buffered host<->device pipeline, SURVEY.md section 2.4).
Files are grouped by (sample_rate, channels) and length-bucketed so a whole
library compiles a handful of graphs (SURVEY.md section 7 'variable-length
batches without recompiles').  Per-file status flows through the persistent
`JobManifest` (resume at file granularity) and the `StatusLog`.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ProcessingConfig
from ..io import aiff, codec, flac, wav
from .calibration import CAPTURE_FRAMES, CalibrationCache
from .graph import process_batch, process_batch_raw
from .logbook import StatusLog, Throughput
from .manifest import FileStatus, JobManifest

__all__ = ["BatchResult", "BatchProcessor", "build_output_path"]

#: files at/above this many source frames get sub-file decode/encode
#: progress (chunked host stages reporting fractional manifest progress —
#: the reference's 10-50 ms per-buffer callbacks,
#: AudioProcessingService.swift:209-264); shorter files keep the cheap
#: 0.3/0.4/0.7/1.0 stage ticks
SUBFILE_PROGRESS_FRAMES = 1 << 21
#: host-stage chunk size (frames) for the sub-file progress paths
SUBFILE_PROGRESS_CHUNK = 1 << 20


def build_output_path(src_path: str, output_dir: str, postfix: str,
                      fmt: str = "wav") -> str:
    """out_dir/<stem><postfix>.<fmt> — mandatory output dir + postfix naming
    (Source/MainComponent.cpp:807-819; AudioProcessingService.swift:652-672)."""
    stem = os.path.splitext(os.path.basename(src_path))[0]
    ext = fmt if fmt in ("aiff", "flac") else "wav"
    return os.path.join(output_dir, f"{stem}{postfix}.{ext}")


@dataclasses.dataclass
class BatchResult:
    completed: int
    failed: int
    invalid: int
    audio_seconds_in: float
    audio_seconds_out: float
    wall_seconds: float
    throughput: dict
    per_file: dict = dataclasses.field(default_factory=dict)
    """Per-file device metrics keyed by input path: out_frames, peak_db,
    rms_db, noise_floor_db (the file-list readouts of the reference, as
    machine-readable data)."""
    skipped: int = 0
    """How many of `completed` were resume skips (already COMPLETED in the
    manifest, output verified) rather than work done this run."""
    aborted: bool = False
    """True when the batch aborted mid-run (device dispatch failure after
    retry): remaining files were failed with 'batch aborted' and a caller
    that retries (watch mode) should re-offer them."""

    @property
    def x_realtime(self) -> float:
        return self.audio_seconds_out / self.wall_seconds if self.wall_seconds else 0.0


@dataclasses.dataclass
class _Decoded:
    entry_path: str
    data: np.ndarray      # (channels, frames) float32
    rate: int
    gain_db: float = 0.0  # per-file loudness-normalization gain


class BatchProcessor:
    """Orchestrates a whole batch: probe -> validate -> calibrate -> pipeline.

    Single source of truth for a run, like ``MainViewModel``
    (ViewModels/MainViewModel.swift:4-528), minus the UI.
    """

    def __init__(
        self,
        cfg: ProcessingConfig,
        log: StatusLog | None = None,
        calibration: CalibrationCache | None = None,
        decode_workers: int = 4,
        encode_workers: int = 4,
        queue_depth: int = 16,
        mesh=None,
    ):
        cfg.validate()
        self.cfg = cfg
        self.log = log or StatusLog()
        self.calibration = calibration or CalibrationCache()
        self.decode_workers = decode_workers
        self.encode_workers = encode_workers
        self.queue_depth = queue_depth
        self.throughput = Throughput()
        #: optional jax.sharding.Mesh: batches are sharded over its "files"
        #: axis (pure data parallelism over chips, SURVEY.md section 2.4);
        #: cfg.batch_size should be a multiple of the files-axis size.
        self.mesh = mesh
        if mesh is not None:
            n = mesh.shape.get("files", 1)
            if cfg.batch_size % n:
                raise ValueError(
                    f"batch_size {cfg.batch_size} not divisible by the mesh's "
                    f"files axis ({n})")

    # ------------------------------------------------------------------- run

    def run(self, files: list[str], manifest_path: str | None = None) -> BatchResult:
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        manifest = (
            JobManifest.load_or_create(files, manifest_path)
            if manifest_path else JobManifest.from_files(files)
        )
        try:
            return self._run(files, manifest)
        finally:
            # exception exits must not leave a live deferred-save timer — a
            # stale fire up to save_interval later could overwrite a newer
            # manifest instance's state on the same path (advisor r3 #2)
            manifest.close()

    def _run(self, files: list[str], manifest: JobManifest) -> BatchResult:
        t_start = time.time()
        cfg = self.cfg
        self.log.append(f"Batch start: {len(files)} file(s) -> {cfg.output_dir}")
        # this run operates strictly on the requested files: a cumulative
        # manifest (watch mode) may carry entries from earlier sweeps, which
        # are not this batch's to probe, rename, fail, or count
        run_files = list(dict.fromkeys(files))
        listed = set(run_files)

        # ---- probe + validate (drop-zone filter + rate validation) ----
        groups: dict[tuple[int, int], list] = {}
        skipped = 0
        for path in run_files:
            e = manifest.get(path)
            if e.status == FileStatus.COMPLETED:
                self.log.append(f"Skip (already completed): {e.path}")
                skipped += 1
                continue
            if not codec.is_supported(e.path):
                manifest.update(e.path, FileStatus.FAILED, error="unsupported file type")
                continue
            try:
                info = codec.probe(e.path)
                in_st = os.stat(e.path)
            except (ValueError, OSError, struct.error, EOFError) as err:
                manifest.update(e.path, FileStatus.FAILED, error=str(err))
                self.log.append(f"Probe failed: {e.path}: {err}")
                continue
            bound_err = cfg.routing_channel_bound_error(info.num_channels)
            if bound_err:
                manifest.update(e.path, FileStatus.FAILED, error=bound_err)
                self.log.append(f"Routing invalid: {e.path}: {bound_err}")
                continue
            if (cfg.require_input_rate is not None
                    and not info.is_valid_for_rate(cfg.require_input_rate)):
                manifest.update(e.path, FileStatus.INVALID_SAMPLE_RATE,
                                sample_rate=info.sample_rate)
                self.log.append(
                    f"Invalid sample rate {info.sample_rate} (require "
                    f"{cfg.require_input_rate}): {e.path}")
                continue
            manifest.update(e.path, FileStatus.PENDING,
                            sample_rate=info.sample_rate,
                            num_channels=info.num_channels,
                            num_frames=info.num_frames,
                            # input signature: resume reprocesses this path
                            # if the source content changes (watch re-drop)
                            input_size=in_st.st_size,
                            input_mtime_ns=in_st.st_mtime_ns)
            # raw fast-path signature: integer-PCM WAV/AIFF/AU ship their
            # container bytes; FLAC decodes on the host (native) and
            # re-packs to the same payload layout, as do G.711 .au
            # sources (exact int16 expansion) — all then decode on
            # device (f9tpu.ops.devcodec, either byte order) and move
            # 2-3 B/sample over the link instead of float32's 4.
            raw_bits = (info.bit_depth
                        if (not info.is_float
                            and info.container in ("wav", "aiff", "flac",
                                                   "au")
                            and info.bit_depth in (16, 24)
                            and cfg.bits in (16, 24)
                            and cfg.normalize_lufs is None)
                        else 0)
            raw_be = bool(raw_bits) and info.byte_order == "big"
            groups.setdefault(
                (info.sample_rate, info.num_channels, raw_bits, raw_be),
                []).append(info)

        # ---- collision-safe output naming: two inputs with the same stem
        # must not write the same output file (concurrent encoders would
        # interleave into one corrupt WAV) ----
        out_paths: dict[str, str] = {}
        taken: dict[str, int] = {}
        # the ORIGINALS are never overwritten (the reference's output-folder
        # protection, _Swift Docs/OUTPUT_FOLDER_PROTECTION.md): an output
        # resolving onto any of this run's inputs (--out == source dir with
        # an empty postfix, or an input named like a deliverable) must be
        # suffixed away, exactly like a name collision
        in_real = {os.path.realpath(p) for p in run_files}
        will_process = {p for p in run_files
                        if manifest.get(p).status == FileStatus.PENDING}
        for e in manifest.entries():
            # deliverables recorded by files NOT being (re)processed this
            # run — earlier runs' entries (cumulative manifest) and this
            # run's already-completed files — are reserved so a new
            # same-stem input can't overwrite them.  A file being
            # reprocessed (content re-drop) keeps its own name free.
            if e.path not in will_process and e.output_path:
                taken.setdefault(e.output_path, 1)
        for path in run_files:
            if path not in will_process:
                continue
            e = manifest.get(path)
            base = build_output_path(e.path, cfg.output_dir, cfg.postfix,
                                     fmt=cfg.output_format)
            if base in taken or os.path.realpath(base) in in_real:
                stem, ext = os.path.splitext(base)
                n = taken.get(base, 1)
                while True:
                    # the suffixed candidate must itself dodge every
                    # reserved name (an earlier run's f_2.wav would
                    # otherwise be silently overwritten) AND every input
                    n += 1
                    out = f"{stem}_{n}{ext}"
                    if out not in taken \
                            and os.path.realpath(out) not in in_real:
                        break
                taken[base] = n
                taken[out] = 1
                self.log.append(
                    f"Output name collision: {os.path.basename(e.path)} -> "
                    f"{os.path.basename(out)}")
            else:
                taken[base] = 1
                out = base
            out_paths[e.path] = out

        # ---- auto-calibration per rate pair (MainViewModel.swift:195-206) ----
        latencies: dict[int, int] = {}
        noise_floors: dict[int, float] = {}
        for rate_in, _, _, _ in groups:
            if rate_in in latencies:
                continue
            if cfg.latency_frames is not None:
                latencies[rate_in] = cfg.latency_frames
                continue
            chain_fn, chain_sig, capture, ringout = None, "", CAPTURE_FRAMES, 0
            if cfg.chain is not None:
                # The measured loop is SRC + the user's insert chain — the
                # impulse passes through exactly what a batch passes through
                # (LatencyMeasurementService.swift:57-171).  Capture sizes
                # with the chain's ring-out so the peak and a post-ring-out
                # noise window both fit.
                chain_sig = cfg.chain.sig_str()
                ringout = int(cfg.chain.tail_frames(cfg.target_rate))
                capture = max(
                    CAPTURE_FRAMES,
                    -(-(3 * ringout + (1 << 15)) * rate_in // cfg.target_rate))
                chain = cfg.chain
                rate_out = cfg.target_rate

                def chain_fn(x, _rate_in=rate_in):
                    from ..ops.resample import resample_rates

                    y = resample_rates(x, _rate_in, rate_out,
                                       quality=cfg.quality, kind=cfg.kind)
                    return chain.apply(y, rate_out)

            cal = self.calibration.get_or_measure(
                rate_in, cfg.target_rate, quality=cfg.quality, kind=cfg.kind,
                chain_fn=chain_fn, chain_sig=chain_sig,
                capture_frames=capture, ringout_frames=ringout)
            if not cal.detected:
                hint = ("" if cfg.chain is None else
                        " (a dynamics stage — slow-attack gate, heavy "
                        "limiter — can suppress the impulse below the "
                        "detection threshold; pass --latency / "
                        "cfg.latency_frames to skip calibration)")
                raise RuntimeError(
                    f"calibration impulse not detected for "
                    f"{rate_in}->{cfg.target_rate}{hint}")
            latencies[rate_in] = cal.latency_frames
            noise_floors[rate_in] = cal.noise_floor_db
            self.log.append(
                f"Calibrated {rate_in}->{cfg.target_rate}: latency "
                f"{cal.latency_frames} frames, noise floor {cal.noise_floor_db:.1f} dB")

        # ---- pipeline stages (persistent across groups and buckets: one
        # decode pool, one collector, one encode pool for the whole run, so
        # bucket N+1 decodes and uploads underneath bucket N's device
        # compute — previously the stage set was torn down and rebuilt per
        # bucket, making cross-bucket overlap structurally impossible) ----
        audio_in = audio_out = 0.0
        stop_event = threading.Event()
        errors: list[str] = []
        per_file_metrics: dict[str, dict] = {}
        norm_info: dict[str, dict] = {}
        from .manifest import file_crc32
        from .stream import stream_resample_file, streaming_exclusions

        # Per-file dither seeds derive from (cfg.seed, path) so reruns are
        # byte-identical regardless of decode-thread arrival order; cfg.seed
        # None opts into wall-clock (non-reproducible) noise.
        base_seed = (cfg.seed if cfg.seed is not None
                     else int(time.time()) & 0x7FFFFFFF)

        def file_seed(path: str) -> int:
            from ..ops.dither import file_seed as _fs

            return _fs(base_seed, path)

        # ---- plan: group -> length buckets; files beyond the largest
        # configured bucket route to the constant-memory streaming path
        # (an exact-fit bucket staged at batch_size width would allocate
        # ~batch_size x file_bytes of host staging and ship multi-GB buffers
        # to a 16 GiB chip) ----
        max_bucket = max(cfg.bucket_frames)
        budget_frames = cfg.batch_size * max_bucket
        mesh_files = (self.mesh.shape.get("files", 1)
                      if self.mesh is not None else 1)
        stream_ok = not streaming_exclusions(cfg)
        stream_jobs: list[tuple] = []          # (info, rate_in, latency)
        buckets: list[dict] = []               # per-bucket context + files

        for (rate_in, channels, raw_bits, raw_be), infos in groups.items():
            infos = [i for i in infos
                     if manifest.get(i.path).status == FileStatus.PENDING]
            if not infos:
                continue
            # NOTE: `channels` is the INPUT channel count (batch layout);
            # routing / mono fan-out to cfg.channel_routing / output_channels
            # happens inside the device graph.
            lat = latencies[rate_in]
            group_nf = cfg.noise_floor_db
            if group_nf is None and cfg.reverb_mode:
                measured = noise_floors.get(rate_in)
                if measured is not None and measured > -150.0:
                    group_nf = measured
                    self.log.append(
                        f"Using measured noise floor {measured:.1f} dB for "
                        f"{rate_in} Hz group")
                else:
                    self.log.append(
                        "No usable noise floor (numerically silent chain); "
                        "using -80 dB fallback for tail detection")
            # bucket by padded length.  The 60 s cap is a *reverb capture*
            # bound (AudioProcessingService.swift:449-452), not a general
            # input limit; beyond-largest-bucket files stream instead, and
            # only stream-ineligible configs fall back to an exact-fit
            # bucket at reduced batch width.
            cap = int(cfg.max_tail_seconds * rate_in) if cfg.reverb_mode else None
            # rate-pair-specific exclusions (round 4: varispeed + FFT-chain
            # grid alignment) need a representative path for the group's rate
            group_stream_ok = (stream_ok and not streaming_exclusions(
                cfg, infos[0].path))
            by_bucket: dict[int, list] = {}
            for info in infos:
                n = info.num_frames
                if cap is not None and n > cap:
                    self.log.append(
                        f"Reverb capture cap: truncating {info.path} to "
                        f"{cfg.max_tail_seconds:.0f} s ({cap} frames)")
                    n = cap
                if cap is None and n > max_bucket and group_stream_ok:
                    stream_jobs.append((info, rate_in, lat))
                    continue
                blen = next((b for b in sorted(cfg.bucket_frames) if n <= b), n)
                by_bucket.setdefault(max(blen, n) if cap is None else
                                     min(max(blen, n), cap), []).append(info)

            # channel-axis sharding (MCFX buses over chips): decided per group
            # since it depends on the input channel count; ineligible groups
            # fall back to files-axis-only sharding with a logged reason
            use_cp = False
            if (self.mesh is not None
                    and self.mesh.shape.get("channels", 1) > 1):
                from ..parallel import channels_shardable

                if raw_bits:
                    self.log.append(
                        "Channel sharding: raw-bytes path has no channel "
                        "axis; decoding on host for this group")
                    # fall through: raw_bits stays, files-axis sharding only
                elif cfg.normalize_lufs is not None:
                    self.log.append(
                        "Channel sharding: loudness normalization uses "
                        "per-file gains (files-axis sharding only)")
                else:
                    use_cp, reason = channels_shardable(cfg, channels, self.mesh)
                    if not use_cp:
                        self.log.append(f"Channel sharding unavailable: {reason}")

            # host-rows marshalling plan: for the rows fast path the host
            # writes each file's samples straight into the (n_rows, M) tiling
            # (a contiguous memcpy), so the device skips the flat->rows
            # retiling
            rows_bank = None
            if (cfg.device_layout == "rows" and not raw_bits and not use_cp
                    and not cfg.reverb_mode and cfg.chain is None
                    and lat == 0):
                from ..models.filters import design_cycle_bank
                from ..ops.resample import rows_pre_applicable
                from ..ops.resample import banded_rows_applicable

                bank_g = design_cycle_bank(rate_in, cfg.target_rate,
                                           quality=cfg.quality, kind=cfg.kind)
                # dense banks marshal (n_rows, M) tiles (resample_rows_pre);
                # varispeed banks marshal overlapping cycle rows for the
                # banded path (resample_banded_rows_pre) — both skip the
                # device-side retiling
                if (rows_pre_applicable(bank_g)
                        or banded_rows_applicable(bank_g)):
                    rows_bank = bank_g

            # output channel count after in-graph routing / mono fan-out
            out_ch = (len(cfg.channel_routing)
                      if cfg.channel_routing is not None
                      else (cfg.output_channels
                            if (cfg.output_channels and channels == 1)
                            else channels))
            for blen, binfos in sorted(by_bucket.items()):
                bs = cfg.batch_size
                if blen > max_bucket:
                    # exact-fit bucket for an oversized file that can't
                    # stream (sharded-only configs; reverb inputs are capped
                    # upstream): shrink the batch so host staging stays
                    # within the normal budget
                    bs = max(1, budget_frames // blen)
                    bs = min(-(-bs // mesh_files) * mesh_files,
                             cfg.batch_size)
                    self.log.append(
                        f"Oversized bucket {blen} frames: batch width "
                        f"reduced to {bs} (memory budget)")
                buckets.append(dict(
                    rate_in=rate_in, channels=channels, raw_bits=raw_bits,
                    raw_be=raw_be, lat=lat, group_nf=group_nf, use_cp=use_cp,
                    rows_bank=rows_bank, out_ch=out_ch, blen=blen,
                    infos=binfos, bs=bs))

        work: list[tuple[int, object]] = [
            (bi, info) for bi, b in enumerate(buckets) for info in b["infos"]]

        dec_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        enc_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        # device->host collector: materialising results (D2H) happens off the
        # dispatch thread so the next batch's H2D + compute overlap the
        # previous batch's download — the double-buffered device queue
        # (SURVEY.md section 2.4).
        res_q: queue.Queue = queue.Queue(maxsize=2)

        loader = None
        if cfg.native_loader and any(not b["raw_bits"] for b in buckets):
            # C++ thread-pool decode for integer-PCM WAVs (the JUCE
            # AudioFormatManager role): file I/O + 16/24-bit conversion +
            # deinterleave run off the GIL.
            from .. import native

            if native.available():
                loader = native.AsyncLoader(n_threads=self.decode_workers)

        def native_eligible(info):
            return (loader is not None and info.container == "wav"
                    and not info.is_float and info.bit_depth in (16, 24))

        def decode_worker(work_q):
            # the finally-sentinel is load-bearing: the main loop counts one
            # None per worker, so early exits (abort, unexpected exception)
            # must still deliver it or run() deadlocks.  Any per-file failure
            # — including unexpected exception types (fault containment) —
            # marks the file FAILED and posts a failure token so the
            # bucket's arrival count still completes.
            #
            # Workers drain ONE shared queue (VERDICT r3 weak #4): the old
            # static work[i::n] split head-of-line-blocked every file behind
            # a slow/huge decode in that worker's private sublist while
            # other workers went idle — a skewed library now load-balances
            # naturally (the queue is pre-filled, so get_nowait()'s Empty IS
            # the exit condition; no sentinel needed on this queue).
            try:
                while True:
                    try:
                        bi, info = work_q.get_nowait()
                    except queue.Empty:
                        return
                    if stop_event.is_set():
                        return
                    raw_bits = buckets[bi]["raw_bits"]
                    try:
                        t0 = time.time()
                        if raw_bits:
                            data, rinfo = codec.read_raw_pcm(info.path)
                            rate = rinfo.sample_rate
                            audio_s = rinfo.num_frames / rate
                        elif info.num_frames >= SUBFILE_PROGRESS_FRAMES:
                            # sub-file decode progress for long files: the
                            # reference's throttled per-buffer callbacks
                            # (AudioProcessingService.swift:209-264) mapped
                            # onto the decode stage's 0 -> 0.3 span.  Checked
                            # BEFORE native eligibility: long files are
                            # exactly the ones whose decode progress matters,
                            # and the native loader has no progress callbacks
                            manifest.update(info.path, FileStatus.PROCESSING,
                                            progress=0.0)
                            data, rate = codec.read_audio_progress(
                                info.path,
                                lambda fr, _p=info.path:
                                    manifest.set_progress(_p, 0.3 * fr),
                                chunk_frames=SUBFILE_PROGRESS_CHUNK)
                            audio_s = data.shape[-1] / rate
                        elif native_eligible(info):
                            ticket = loader.submit(
                                info.path, info.num_channels,
                                info.num_frames)
                            data, rate = loader.wait(
                                ticket,
                                timeout=max(120.0, info.num_frames * 1e-4))
                            audio_s = data.shape[-1] / rate
                        else:
                            data, rate = codec.read_audio(info.path)
                            audio_s = data.shape[-1] / rate
                        self.throughput.add("decode", audio_s, time.time() - t0)
                        gain_db = 0.0
                        if cfg.normalize_lufs is not None and not raw_bits:
                            # the chunk-exact streamed meter + shared gain
                            # rule: the SAME functions the streaming path
                            # uses, so a file processed either way gets the
                            # bit-identical gain (and therefore
                            # bit-identical output bytes)
                            from ..ops.loudness import (
                                array_reader, meter_source_streamed,
                                normalization_gain_db, surround_weights)

                            m = meter_source_streamed(
                                array_reader(data), data.shape[0],
                                data.shape[-1], rate,
                                want_tp=cfg.normalize_tp_db is not None,
                                weights=(surround_weights(data.shape[0])
                                         if cfg.surround_weights else None))
                            lufs = m["lufs"]
                            if lufs > -199.0:
                                gain_db, note = normalization_gain_db(
                                    cfg.normalize_lufs, lufs, cfg.gain_db,
                                    cfg.normalize_tp_db,
                                    m["true_peak_db"])
                                norm_info[info.path] = {
                                    "source_lufs": round(lufs, 2),
                                    "applied_gain_db": round(gain_db, 2),
                                }
                                self.log.append(
                                    f"Normalize: "
                                    f"{os.path.basename(info.path)} "
                                    f"{lufs:.1f} LUFS -> "
                                    f"{cfg.normalize_lufs:.1f} "
                                    f"({gain_db:+.1f} dB{note})")
                        # per-file progress stages (the reference's throttled
                        # progress callbacks, AudioProcessingService.swift:209-214):
                        # decoded 0.3 -> device done 0.7 -> encoded 1.0
                        manifest.update(info.path, FileStatus.PROCESSING,
                                        progress=0.3)
                        dec_q.put((bi, _Decoded(info.path, data, rate,
                                                gain_db=gain_db)))
                    except Exception as err:
                        manifest.update(info.path, FileStatus.FAILED,
                                        error=str(err))
                        self.log.append(f"Decode failed: {info.path}: {err}")
                        dec_q.put((bi, None))
            finally:
                dec_q.put(None)

        def put_enc(item) -> bool:
            # abort-aware bounded put: if the encode pool ever died
            # (catastrophic, beyond the broad containment below), the
            # collector must not wedge forever on a full queue
            while not stop_event.is_set():
                try:
                    enc_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def encode_worker():
            while True:
                item = enc_q.get()
                if item is None:
                    return
                path, codes, out_frames, rate_out, metrics = item
                part = None
                try:
                    t0 = time.time()
                    out_path = out_paths[path]
                    # atomic publish: encode to a .part file and os.replace
                    # at completion — the out dir is the drop-zone's public
                    # interface, and a consumer polling it must never see a
                    # half-written deliverable (nor a crash leave one at the
                    # final name)
                    part = out_path + ".part"
                    fmt = cfg.output_format
                    prog = None
                    if out_frames >= SUBFILE_PROGRESS_FRAMES:
                        # sub-file encode progress (0.7 -> 1.0 span); the
                        # COMPLETED update below pins exactly 1.0
                        prog = (lambda fr, _p=path:
                                manifest.set_progress(_p, 0.7 + 0.3 * fr))
                    if metrics.get("payload"):
                        # device-packed 24/16-bit bytes: header + fwrite
                        # (FLAC unpacks to codes on the host — the narrow
                        # wire is about LINK bytes, which are identical)
                        out_ch = metrics["out_channels"]
                        bpsamp = cfg.bits // 8
                        writer = {"aiff": aiff.write_aiff_payload,
                                  "flac": flac.write_flac_payload,
                                  }.get(fmt, wav.write_wav_payload)
                        writer(part, codes[: out_frames * out_ch * bpsamp],
                               out_ch, rate_out, bits=cfg.bits,
                               progress_cb=prog,
                               chunk_frames=SUBFILE_PROGRESS_CHUNK)
                    else:
                        writer = {"aiff": aiff.write_aiff_codes,
                                  "flac": flac.write_flac_codes,
                                  }.get(fmt, wav.write_wav_codes)
                        writer(part, codes[:, :out_frames], rate_out,
                               bits=cfg.bits, progress_cb=prog,
                               chunk_frames=SUBFILE_PROGRESS_CHUNK)
                    if cfg.keep_metadata:
                        # the ONE shared same-container rule
                        # (io.codec.carry_metadata) — the streaming path
                        # calls the same helper, so metadata survival can
                        # never depend on which path a file took
                        try:
                            codec.carry_metadata(
                                path, part, cfg.output_format,
                                metrics.get("rate_in", rate_out), rate_out)
                        except (ValueError, OSError, MemoryError) as err:
                            self.log.append(
                                f"Metadata passthrough skipped for "
                                f"{os.path.basename(path)}: {err}")
                    os.replace(part, out_path)
                    self.throughput.add("encode", out_frames / rate_out,
                                        time.time() - t0)
                    out_st = os.stat(out_path)
                    manifest.update(
                        path, FileStatus.COMPLETED,
                        output_path=out_path,
                        output_size=out_st.st_size,
                        output_crc32=file_crc32(out_path),
                        output_mtime_ns=out_st.st_mtime_ns,
                        metrics=per_file_metrics.get(path),
                        progress=1.0)
                    self.log.append(
                        f"Completed: {os.path.basename(out_path)} "
                        f"({out_frames} frames @ {rate_out} Hz, "
                        f"peak {metrics['peak_db']:.1f} dB)")
                except Exception as err:
                    # broad containment: ANY write-path failure — including
                    # container-size struct errors — fails the file and
                    # keeps the worker alive, so the bounded enc_q keeps
                    # draining and the run exits cleanly instead of hanging
                    manifest.update(path, FileStatus.FAILED, error=str(err))
                    self.log.append(f"Encode failed: {path}: {err}")
                    errors.append(str(err))
                    if part is not None:
                        try:
                            os.unlink(part)
                        except OSError:
                            pass

        def collector():
            nonlocal audio_in, audio_out
            while True:
                item = res_q.get()
                if item is None:
                    return
                bi, c_paths, res, c_valid, c_rate_in = item
                b = buckets[bi]
                # stage wall = the collector's BLOCKING time materialising
                # this batch (device + D2H still outstanding at collect
                # time).  Submit-to-materialise latency is the wrong number
                # here: in-flight batches overlap, so summed latencies
                # exceed the run wall and the ratio reads as a throughput
                # far below what the pipeline actually sustains (a 61x-RT
                # run used to report a 28x "device stage").  One collector
                # thread -> these waits never overlap and compose with wall.
                t_blk = time.time()
                try:
                    # start ALL host copies before blocking on any, so the
                    # four scalar metric transfers overlap the big codes
                    # transfer instead of queueing after it
                    for a in (res.codes, res.out_frames, res.peak_db,
                              res.rms_db, res.noise_floor_db):
                        try:
                            a.copy_to_host_async()
                        except AttributeError:
                            break          # non-jax array (tests/CPU stubs)
                    codes = np.asarray(res.codes)
                    if res.layout == "rows":
                        # host-side flatten of the device rows tiling
                        # (free here; ~10x the SRC cost on device).
                        # rows results are always int32 (f, C, n, L);
                        # the native pack24 runs at encode time
                        codes = codes.reshape(
                            codes.shape[0], codes.shape[1], -1)
                    out_frames = np.asarray(res.out_frames)
                    pk = np.asarray(res.peak_db)
                    rms = np.asarray(res.rms_db)
                    nf = np.asarray(res.noise_floor_db)
                except Exception as err:
                    stop_event.set()
                    manifest.fail_remaining(f"device step failed: {err}", paths=listed)
                    self.log.append(f"BATCH ABORT: device step failed: {err}")
                    errors.append(str(err))
                    continue
                # floor the blocking time at 1 ms/batch: in producer-bound
                # runs a batch can be fully materialised by collect time and
                # the near-zero denominator would log an implausible
                # x-realtime — the inverse misreading of the overlap bug the
                # blocking-time counter fixed (advisor r3 #3).  The floor
                # caps the reported stage ratio at audio_s x 1000/batch,
                # which reads as "not the bottleneck" without being absurd.
                self.throughput.add(
                    "device", float(c_valid.sum()) / c_rate_in,
                    max(time.time() - t_blk, 1e-3))
                for i, p in enumerate(c_paths):
                    manifest.set_progress(p, 0.7)
                    audio_in += c_valid[i] / c_rate_in
                    audio_out += int(out_frames[i]) / cfg.target_rate
                    per_file_metrics[p] = {
                        "out_frames": int(out_frames[i]),
                        "peak_db": round(float(pk[i]), 2),
                        "rms_db": round(float(rms[i]), 2),
                        "noise_floor_db": round(float(nf[i]), 2),
                        **norm_info.get(p, {}),
                    }
                    delivered = put_enc(
                        (p, codes[i], int(out_frames[i]), cfg.target_rate,
                         {"peak_db": float(pk[i]),
                          "rate_in": c_rate_in,
                          "payload": bool(b["raw_bits"])
                                     and res.layout == "flat",
                          "out_channels": b["out_ch"]}))
                    if not delivered:
                        manifest.update(p, FileStatus.FAILED,
                                        error="aborted before encode")

        pending: dict[int, list] = {bi: [] for bi in range(len(buckets))}
        total = {bi: len(b["infos"]) for bi, b in enumerate(buckets)}
        got = {bi: 0 for bi in range(len(buckets))}

        def flush(bi: int):
            batch_x = pending[bi]
            if not batch_x:
                return
            b = buckets[bi]
            blen, channels, raw_bits = b["blen"], b["channels"], b["raw_bits"]
            paths = [d.entry_path for d in batch_x]
            # Always submit the bucket's full batch width (zero-padded) so
            # every flush reuses the same compiled graph.
            bs = b["bs"]
            valid = np.zeros(bs, np.int32)
            seeds = np.zeros(bs, np.int32)
            gains = np.zeros(bs, np.float32)
            for i, d in enumerate(batch_x):
                seeds[i] = file_seed(d.entry_path)
                gains[i] = d.gain_db
            norm_gains = (gains if cfg.normalize_lufs is not None
                          else None)
            if raw_bits:
                bpf = channels * (raw_bits // 8)
                x = np.zeros((bs, blen * bpf), np.uint8)
                for i, d in enumerate(batch_x):
                    nb = min(len(d.data), blen * bpf)
                    x[i, :nb] = d.data[:nb]
                    valid[i] = nb // bpf
            elif b["rows_bank"] is not None and b["rows_bank"].G is None:
                # varispeed bank: marshal OVERLAPPING cycle rows for the
                # banded path — a strided window view over flat staging
                # (rows overlap by row_width - M, ~1% extra bytes); the
                # device skips its cycle retiling
                from ..ops.resample import banded_rows_plan, marshal_banded_rows

                bank_v = b["rows_bank"]
                n_rows, w_row, pf = banded_rows_plan(bank_v, blen)
                total_len = (n_rows - 1) * bank_v.M + w_row
                flat = np.zeros((bs, channels, total_len), np.float32)
                for i, d in enumerate(batch_x):
                    n = min(d.data.shape[-1], blen)
                    valid[i] = n
                    # the n_rows windows read at most total_len - pf input
                    # samples; any excess is unread (the flat path's keep_T
                    # truncation drops it too).  Defensive clamp: across all
                    # measured real banks total_len - pf >= blen holds, but
                    # the margin runs as low as ~5 frames at NTSC ratios —
                    # a future bank geometry must degrade to the flat-path
                    # semantics, not overflow the staging slice
                    nc = min(n, total_len - pf)
                    if nc > 0:
                        flat[i, :, pf : pf + nc] = d.data[:, :nc]
                x = marshal_banded_rows(flat, bank_v)
            elif b["rows_bank"] is not None:
                # host-rows marshalling: write samples at flat offset
                # pad_front of the zero (n_rows, M) tiling (contiguous
                # memcpy); the device starts straight at the matmul
                from ..ops.resample import rows_marshal_plan

                n_rows, pf = rows_marshal_plan(b["rows_bank"], blen)
                mm = b["rows_bank"].M
                x = np.zeros((bs, channels, n_rows * mm), np.float32)
                for i, d in enumerate(batch_x):
                    n = min(d.data.shape[-1], blen)
                    x[i, :, pf : pf + n] = d.data[:, :n]
                    valid[i] = n
                x = x.reshape(bs, channels, n_rows, mm)
            else:
                x = np.zeros((bs, channels, blen), np.float32)
                for i, d in enumerate(batch_x):
                    n = min(d.data.shape[-1], blen)
                    x[i, :, :n] = d.data[:, :n]
                    valid[i] = n
            for d in batch_x:
                # staged-for-device tick between decoded (0.3) and device
                # done (0.7) so long device waits aren't a progress silence
                manifest.set_progress(d.entry_path, 0.4)
            sub = jnp.asarray(seeds)
            if self.mesh is not None:
                from ..parallel.mesh import NamedSharding, P

                spec = (P("files", None) if raw_bits
                        else (P("files", "channels", None) if b["use_cp"]
                              else P(*(["files"] + [None] * (x.ndim - 1)))))
                x = jax.device_put(x, NamedSharding(self.mesh, spec))
            def dispatch():
                # dispatch only — results stay on device; the collector
                # thread materialises them (D2H) while the next batch is
                # assembled and dispatched
                use_rows = cfg.device_layout == "rows"
                if b["use_cp"]:
                    from ..parallel import process_batch_channels_sharded

                    return process_batch_channels_sharded(
                        x, valid, cfg, b["rate_in"], seeds, self.mesh,
                        latency_frames=b["lat"],
                        noise_floor_db=b["group_nf"])
                if raw_bits:
                    return process_batch_raw(
                        x, valid, cfg, b["rate_in"], sub,
                        in_channels=channels, in_bits=raw_bits,
                        in_big_endian=b["raw_be"],
                        latency_frames=b["lat"],
                        noise_floor_db=b["group_nf"],
                        rows_layout=use_rows)
                return process_batch(
                    x, valid, cfg, b["rate_in"], sub,
                    latency_frames=b["lat"],
                    noise_floor_db=b["group_nf"], rows_layout=use_rows,
                    per_file_gain_db=norm_gains)

            try:
                res = dispatch()
            except Exception as err:
                # one retry before aborting: a transient device or compile
                # failure gets a second chance; a deterministic error fails
                # identically and still aborts
                self.log.append(
                    f"device step failed ({err}); retrying once")
                time.sleep(2.0)
                try:
                    res = dispatch()
                except Exception as err2:  # compile/dispatch failure
                    stop_event.set()
                    manifest.fail_remaining(f"device step failed: {err2}", paths=listed)
                    self.log.append(
                        f"BATCH ABORT: device step failed: {err2}")
                    errors.append(str(err2))
                    pending[bi] = []
                    return
            res_q.put((bi, paths, res, valid.copy(), b["rate_in"]))
            pending[bi] = []

        dec_threads = []
        if work:
            work_q: queue.Queue = queue.Queue()
            for item in work:
                work_q.put(item)
            for _ in range(min(self.decode_workers, len(work))):
                t = threading.Thread(target=decode_worker, args=(work_q,),
                                     daemon=True)
                t.start()
                dec_threads.append(t)
        enc_threads = [threading.Thread(target=encode_worker, daemon=True)
                       for _ in range(self.encode_workers)]
        for t in enc_threads:
            t.start()
        collector_thread = threading.Thread(target=collector, daemon=True)
        collector_thread.start()

        done_workers = 0
        while done_workers < len(dec_threads):
            item = dec_q.get()
            if item is None:
                done_workers += 1
                continue
            bi, dec = item
            got[bi] += 1
            if stop_event.is_set():
                continue  # aborted: drain the queue, no more batches
            if dec is not None:
                pending[bi].append(dec)
                if len(pending[bi]) >= buckets[bi]["bs"]:
                    flush(bi)
            if got[bi] == total[bi]:
                # every file of this bucket has arrived (or failed): flush
                # the partial batch now so decoded audio never sits waiting
                # on another bucket's progress
                flush(bi)
        if not stop_event.is_set():
            for bi in range(len(buckets)):
                flush(bi)   # safety sweep
        res_q.put(None)
        collector_thread.join()
        for _ in enc_threads:
            enc_q.put(None)
        for t in enc_threads:
            t.join()
        for t in dec_threads:
            t.join()
        if loader is not None:
            loader.close()

        # ---- oversized files: the constant-memory streaming path, with the
        # same manifest/status flow and sub-file progress surfaced through
        # the manifest (the reference's per-buffer progress callbacks,
        # AudioProcessingService.swift:209-264) ----
        for info, s_rate_in, s_lat in stream_jobs:
            if stop_event.is_set():
                break
            out_path = out_paths[info.path]
            self.log.append(
                f"Oversized ({info.num_frames} frames > largest bucket "
                f"{max_bucket}): streaming {os.path.basename(info.path)}")
            manifest.update(info.path, FileStatus.PROCESSING, progress=0.0)
            try:
                t0 = time.time()
                n = stream_resample_file(
                    info.path, out_path, cfg,
                    progress_cb=lambda p, _p=info.path:
                        manifest.set_progress(_p, p),
                    latency_frames=s_lat)
                # a whole-stream wall (decode+link+encode) must not pollute
                # the device-resident stage counters PERF.md compares
                self.throughput.add("stream", info.num_frames / s_rate_in,
                                    time.time() - t0)
                audio_in += info.num_frames / s_rate_in
                audio_out += n / cfg.target_rate
                per_file_metrics[info.path] = {"out_frames": int(n),
                                               "streamed": True}
                out_st = os.stat(out_path)
                manifest.update(
                    info.path, FileStatus.COMPLETED,
                    output_path=out_path,
                    output_size=out_st.st_size,
                    output_crc32=file_crc32(out_path),
                    output_mtime_ns=out_st.st_mtime_ns,
                    metrics=per_file_metrics[info.path],
                    progress=1.0)
                self.log.append(
                    f"Completed (streamed): {os.path.basename(out_path)} "
                    f"({n} frames @ {cfg.target_rate} Hz)")
            except Exception as err:
                manifest.update(info.path, FileStatus.FAILED, error=str(err))
                self.log.append(f"Stream failed: {info.path}: {err}")
                errors.append(str(err))
                # stream_resample_file owns its .part lifecycle (removed
                # on any failure inside the wrapper)

        if stop_event.is_set():
            # final sweep: a decode worker may have flipped a file to
            # PROCESSING after the abort's fail_remaining ran
            manifest.fail_remaining("batch aborted", paths=listed)
        manifest.save()  # flush throttled status writes
        counts = manifest.counts(listed)
        wall = time.time() - t_start
        result = BatchResult(
            completed=counts.get("completed", 0),
            failed=counts.get("failed", 0),
            invalid=counts.get("invalid_sample_rate", 0),
            audio_seconds_in=audio_in,
            audio_seconds_out=audio_out,
            wall_seconds=wall,
            throughput=self.throughput.summary(),
            per_file=per_file_metrics,
            skipped=skipped,
            aborted=stop_event.is_set(),
        )
        # tiny batches on a cold cache run below 10x; whole-number rounding
        # printed those as "0x real time", which reads as a stall
        xrt = result.x_realtime
        xrt_s = f"{xrt:.0f}x" if xrt >= 10 else f"{xrt:.2f}x"
        self.log.append(
            f"Batch done in {wall:.2f}s: {result.completed} completed, "
            f"{result.failed} failed, {result.invalid} invalid rate "
            f"({xrt_s} real time)")
        return result
