"""Streaming SRC for arbitrarily long files: chunked overlap-save through the
device with constant memory.

The reference caps captures at 60 s (Source/MainComponent.cpp:115) and streams
in 128-1024-sample callback blocks; here a file of any length flows through
fixed-shape device chunks aligned to whole cycles (multiples of M input
frames), with the filter halo read directly from the file on both sides of
each chunk — the host-side twin of the ppermute halo exchange in
`f9tpu.parallel.sharding` (SURVEY.md section 5 'long-context').

Output is written incrementally (24-bit codes per chunk), so peak memory is
one chunk regardless of file length.  DC removal needs the whole-file mean
(the reference computes it over the full capture,
Source/MainComponent.cpp:884-902), so it runs as a cheap host pre-pass.
"""

from __future__ import annotations

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ProcessingConfig
from ..io.aiff import AiffWriter
from ..io.flac import FlacWriter
from ..io.wav import WavWriter

#: output container -> incremental writer (shared open/append/close shape)
_WRITERS = {"aiff": AiffWriter, "flac": FlacWriter}
from ..models.filters import design_cycle_bank
from ..ops import dither
from ..ops.resample import resample_presliced

__all__ = ["stream_resample_file", "stream_chunk_plan",
           "streaming_exclusions"]


def streaming_exclusions(cfg: ProcessingConfig, in_path: str | None = None,
                         sharded: bool = False) -> list[str]:
    """Reasons this config cannot run on the streaming path (empty = can).

    The ONE source of truth for streaming-path feature coverage: the
    scheduler consults it to decide whether an oversized file can be routed
    here (VERDICT round 2 #2), and `stream_resample_file` raises the first
    reason.  Lifting an exclusion (round 3: routing, AIFF input, loudness
    normalization, then latency trim / reverb tails / insert chains on the
    SHARDED path too) automatically widens the scheduler's routing.

    As of round 3's final state the list was empty for every config: the
    sharded stream gathers each super-chunk's SRC output in file order, so
    the sequential stages (chain continuation, latency trim, the incremental
    tail detector) run exactly as they do single-chip — the chain stage on
    one device (its state is sequential over frames; the frames-sharded part
    is the SRC, where the FLOPs are), trim and detection on the host stream.

    Round 4 adds ONE narrow gate: byte-exact streaming of an FFT-convolution
    chain requires chunk lengths that are multiples of both the SRC's
    upsample factor L and the chain's FFT block (`Chain.stream_grid`).  For
    ordinary rational pairs that chunk is small (L=147 -> ~13 s), but a
    VARISPEED ratio's L is in the ten-thousands, and gcd(L, 2^k) is tiny —
    the aligned chunk would reach tens of megaframes (a compile/memory
    hazard, CLAUDE.md 'fresh multi-megaframe programs').  Such configs are
    excluded loudly; the scheduler's existing fallback routes them to an
    exact-fit reduced-width batch instead."""
    del sharded
    if cfg.chain is not None and in_path is not None:
        g = int(cfg.chain.stream_grid(cfg.target_rate))
        if g > 1:
            import math

            from ..io import codec
            from ..models.filters import resolve_ratio

            try:
                rate_in = codec.probe(in_path).sample_rate
            except (OSError, ValueError):
                return []     # unreadable input fails later, with its own error
            L, _M = resolve_ratio(rate_in, cfg.target_rate)
            m = g // math.gcd(L, g)
            if m * L > (1 << 23):
                return [
                    f"chain FFT-grid alignment needs {m * L}-frame chunks "
                    f"for ratio L={L} (over the 2^23 budget); this "
                    "varispeed + FFT-chain config cannot stream — use the "
                    "batch path"]
    return []


def stream_chunk_plan(bank, chunk_seconds: float, rate_in: int) -> int:
    """Chunk length in input frames: whole cycles, ~chunk_seconds long."""
    cycles = max(1, int(chunk_seconds * rate_in) // bank.M)
    return cycles * bank.M


class _TailDetector:
    """Host-side incremental mirror of `ops.trim.detect_tail_end`: the same
    hop-aligned windows (window w = hop-chunks w..w+factor-1), the same
    threshold rule (nf + nf*margin%, -80 dB fallback), the same
    N-consecutive-quiet-windows termination — evaluated as the emitted
    stream flows past, so reverb-mode tails stream in constant memory
    without the batch path's bounded capture.  A window's verdict is known
    exactly when its last frame has been fed, so detection never lags the
    write position (no write-behind buffering needed).

    The detector sees the POST-gain emitted signal (the batch graph detects
    pre-gain), so the threshold is shifted by the applied gain to keep the
    decision identical."""

    def __init__(self, rate_out: int, min_frames: int, cfg,
                 gain_db_total: float, noise_floor_db: float | None):
        import collections

        win = max(1, rate_out * cfg.tail_window_ms // 1000)
        self.hop = max(1, rate_out * cfg.tail_hop_ms // 1000)
        self.factor = -(-win // self.hop)
        self.consecutive = int(cfg.tail_consecutive)
        nf = noise_floor_db
        thr = (nf + nf * float(cfg.noise_floor_margin_pct) / 100.0
               if (nf is not None and nf < 0) else -80.0)
        self.threshold_db = thr + gain_db_total
        self.mode = cfg.tail_mode
        self.min_frames = int(min_frames)
        self._stats = collections.deque(maxlen=self.factor)
        self._n_chunks = 0
        self._run = 0
        self._rem = np.zeros(0, np.float32)

    def feed(self, env: np.ndarray) -> int | None:
        """Feed the next per-frame statistic values — loudest-channel
        |envelope| (peak mode) or channel-mean SQUARE (rms mode, the C++
        buffer-RMS rule); returns the absolute end frame the moment
        termination is confirmed."""
        buf = (np.concatenate([self._rem, env])
               if self._rem.size else np.asarray(env))
        n_complete = len(buf) // self.hop
        for k in range(n_complete):
            seg = buf[k * self.hop : (k + 1) * self.hop]
            self._stats.append(float(seg.max()) if self.mode == "peak"
                               else float(seg.sum(dtype=np.float64)))
            self._n_chunks += 1
            if len(self._stats) < self.factor:
                continue
            w = self._n_chunks - self.factor        # window index
            if self.mode == "peak":
                level = max(self._stats)
                level_db = (20.0 * np.log10(max(level, 1e-30))
                            if level > 0 else -200.0)
            else:
                e = sum(self._stats) / (self.factor * self.hop)
                level_db = (10.0 * np.log10(max(e, 1e-30))
                            if e > 0 else -200.0)
            end_w = (w + self.factor) * self.hop
            quiet = level_db < self.threshold_db and end_w >= self.min_frames
            self._run = self._run + 1 if quiet else 0
            if self._run >= self.consecutive:
                return end_w
        self._rem = buf[n_complete * self.hop :]
        return None


def _finish_chunk(y, carry, seeds_c, pos0, gain, *, rate_out, bits,
                  do_dither, chain=None, chain_pos=None, silent=None,
                  want_env=False, env_rms=False, wire=None):
    """Everything downstream of the SRC for one streamed chunk: chain
    continuation, gain, position-keyed dither/quantize, silent-channel
    zeroing.  Shared (traced inline) by the single-chip `_stream_step` and
    the sharded `_chain_finish_step`, so both topologies run the SAME ops
    and stay byte-identical.

    ``carry`` is the chain's streaming-state pytree (`Chain.stream_init`):
    per-stage input-context rings for direct FIR-type stages, the
    Compressor's envelope scan state, and FFT stages' UPOLS delay lines —
    threaded chunk to chunk so the emitted stream is byte-exact with the
    whole-file `Chain.apply` (ops/chain.py `apply_stream`; chunks are sized
    to the chain's `stream_grid`).
    ``chain_pos``: traced absolute chunk start in the chain-input stream
    (pre-trim output frames — the Compressor's envelope grid is keyed to it).

    ``want_env`` (reverb mode): additionally return the loudest-channel
    |envelope| of the post-gain, PRE-dither float signal for the tail
    detector.  Detecting on the float signal (as the batch path's
    `detect_tail_end` does) rather than the dequantized codes matters at
    16 bits: the TPDF dither floor's 100 ms window peak sits near
    -90 dBFS — ABOVE usable tail thresholds — so a codes-based detector
    could never fire there."""
    if chain is not None:
        y_out, new_carry = chain.apply_stream(y, carry, rate_out, chain_pos)
    else:
        y_out, new_carry = y, carry
    y_out = y_out * gain
    # detector statistic stream: loudest-channel |envelope| (peak mode) or
    # per-frame mean square over ALL channels (rms mode — the C++ buffer-RMS
    # rule the batch detect_tail_end mirrors)
    env = ((jnp.mean(jnp.square(y_out), axis=0) if env_rms
            else jnp.max(jnp.abs(y_out), axis=0)) if want_env else None)
    if do_dither:
        # noise keyed by (seed, channel, ABSOLUTE output frame pos0+j):
        # bytes are chunk-size invariant and identical to the batch path's
        pos = pos0 + jnp.arange(y_out.shape[-1], dtype=jnp.int32)[None, :]
        codes = dither.quantize_noise(y_out, bits, seeds_c[:, None], pos)
    else:
        codes = dither.quantize_noise(y_out, bits)
    if silent:
        mask = np.zeros((codes.shape[0], 1), bool)
        mask[list(silent)] = True
        codes = jnp.where(jnp.asarray(mask), 0, codes)
    # wire format of the D2H download: "pack24" packs the 24-bit codes into
    # interleaved bytes ON DEVICE (3 B/sample instead of int32's 4, the
    # streaming twin of the batch path's `device_layout="packed"`);
    # "i16" narrows 16-bit codes to int16 (2 B/sample, value-exact).
    # The emitted BYTES are identical either way — only the transport
    # narrows (writers pack int32 codes to the same layout on the host).
    if wire == "pack24":
        from ..ops.devcodec import pack24_interleaved

        codes = pack24_interleaved(codes)
    elif wire == "i16":
        codes = codes.astype(jnp.int16)
    if want_env:
        return codes, env, new_carry
    return codes, new_carry


def _raw_front(xp, *, in_wire, in_channels, fanout=0, routing=None,
               mean=None, valid_lo=None, valid_hi=None,
               idx_offset=None):
    """The on-device input front for the raw H2D wire, traced inline by BOTH
    the single-chip `_stream_step` and the sharded `_decode_span_sharded`
    (one body, so the two topologies decode bit-identically): container-byte
    unpack, mono fan-out, routing gather, and DC-mean subtraction over the
    REAL sample span only (zero-padded halos must stay exactly zero — a
    -mean step in the halos would smear an edge transient through the
    filter).  ``valid_lo``/``valid_hi`` are traced scalars (edge chunks
    never recompile); ``idx_offset`` shifts the local position iota to
    global coordinates inside a shard_map block."""
    from ..ops.devcodec import unpack_pcm_interleaved

    in_bits, in_be = in_wire
    x = unpack_pcm_interleaved(xp, in_channels, in_bits, big_endian=in_be)
    if fanout:                          # mono fan-out (host twin: routed())
        x = jnp.broadcast_to(x, (fanout, x.shape[-1]))
    if routing is not None:
        r = np.asarray(routing, np.int32)
        x = jnp.where((r < 0)[:, None], jnp.float32(0.0),
                      x[np.where(r < 0, 0, r)])
    if mean is not None:
        idx = jnp.arange(x.shape[-1], dtype=jnp.int32)
        if idx_offset is not None:
            idx = idx + idx_offset
        real = (idx >= valid_lo) & (idx < valid_hi)
        x = x - jnp.where(real, mean, jnp.float32(0.0))
    return x


@functools.partial(jax.jit, static_argnames=("cycles", "rate_in", "rate_out",
                                             "quality", "kind", "bits",
                                             "do_dither", "chain",
                                             "silent",
                                             "want_env", "env_rms",
                                             "rows_form", "wire", "in_wire",
                                             "in_channels", "fanout",
                                             "routing"))
def _stream_step(xp, carry, seeds_c, pos0, gain, *, cycles, rate_in, rate_out,
                 quality, kind, bits, do_dither, chain=None,
                 chain_pos=None, silent=None, want_env=False, env_rms=False,
                 rows_form=False, wire=None, in_wire=None, in_channels=0,
                 fanout=0, routing=None, mean=None, valid_lo=None,
                 valid_hi=None):
    """``gain`` is a TRACED float32 scalar (static gain x per-file
    normalization gain as one linear factor): per-file gains never recompile.
    ``silent``: static tuple of routed-silent output channel indices — their
    codes stay digital zero even under dither, matching the batch graph.

    ``rows_form`` (varispeed banks): ``xp`` arrives HOST-MARSHALLED as
    overlapping cycle rows ``(C, cycles, w_rows)`` instead of the flat padded
    chunk, skipping the device-side cycle retiling — the streaming twin of the
    batch scheduler's ``device_layout="rows"`` dispatch.  Bitwise-identical
    to the flat form: both trace the one ``_banded_eval_rows``.

    ``in_wire`` = (bits, big_endian) (raw H2D upload):
    ``xp`` arrives as the container's interleaved integer-PCM BYTES
    (zero-padded to the chunk span on the host — zero bytes decode to zero
    samples) and the decode / mono fan-out / routing gather / DC-mean
    subtraction run ON DEVICE, replicating the host `routed()` + pre-pass
    math op for op (integer→float scaling is a power of two, so the floats
    are bitwise identical to the host decode).  3 B/sample up the link
    instead of float32's 4 (2 B for 16-bit sources)."""
    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    if in_wire is not None:
        xp = _raw_front(xp, in_wire=in_wire, in_channels=in_channels,
                        fanout=fanout, routing=routing, mean=mean,
                        valid_lo=valid_lo, valid_hi=valid_hi)
    if rows_form:
        from ..ops.resample import resample_banded_rows_pre

        y = resample_banded_rows_pre(xp, bank)          # (C, cycles, L)
        y = y.reshape(*y.shape[:-2], cycles * bank.L)
    else:
        y = resample_presliced(xp, bank, cycles)
    return _finish_chunk(y, carry, seeds_c, pos0, gain, rate_out=rate_out,
                         bits=bits, do_dither=do_dither, chain=chain,
                         chain_pos=chain_pos, silent=silent,
                         want_env=want_env, env_rms=env_rms, wire=wire)


@functools.partial(jax.jit, static_argnames=("rate_out", "bits", "do_dither",
                                             "chain",
                                             "silent", "want_env",
                                             "env_rms", "wire"))
def _chain_finish_step(y, carry, seeds_c, pos0, gain, *, rate_out, bits,
                       do_dither, chain, chain_pos, silent,
                       want_env=False, env_rms=False, wire=None):
    """Sharded-stream tail when a chain is configured: the super-chunk's SRC
    output (gathered — chain state is sequential over frames, so this stage
    runs on one device while the SRC itself stays frames-sharded) through
    the SAME `_finish_chunk` the single-chip path traces."""
    return _finish_chunk(y, carry, seeds_c, pos0, gain, rate_out=rate_out,
                         bits=bits, do_dither=do_dither, chain=chain,
                         chain_pos=chain_pos, silent=silent,
                         want_env=want_env, env_rms=env_rms, wire=wire)


class _Emitter:
    """The shared tail of both streaming loops (single-chip and sharded):
    latency-drop accounting, out-limit clamp, reverb-tail detector feed with
    mid-block truncation on fire, incremental write, progress.  One copy so
    the two topologies cannot drift (their byte-parity is a tested
    contract)."""

    def __init__(self, writer, detector, *, lat, out_limit, out_total,
                 progress_cb=None, wire=None, channels=0):
        self.writer = writer
        self.detector = detector
        self.lat = int(lat)
        self.out_limit = int(out_limit)
        self.out_total = int(out_total)
        self.progress_cb = progress_cb
        self.written = 0
        self.g0 = 0          # pre-trim output frame index of the next chunk
        #: "pack24": chunks arrive as device-packed interleaved 24-bit BYTES
        #: (1-D uint8, `devcodec.pack24_interleaved`) instead of (C, n) int
        #: codes; frame slicing becomes byte slicing at stride channels*3
        self.wire = wire
        self._stride = channels * 3

    def _append(self, codes: np.ndarray, drop: int, take: int) -> None:
        if self.wire == "pack24":
            self.writer.append_payload(
                codes[drop * self._stride : (drop + take) * self._stride])
        else:
            self.writer.append_codes(codes[:, drop : drop + take])

    def emit_head(self, codes: np.ndarray, env) -> bool:
        """Write the acausal-latency zero head (dithered digital silence at
        output positions 0..|lat|) BEFORE the first chunk: the streaming
        twin of `trim_latency`'s negative right-shift.  Does not advance
        ``g0`` (the head is not a pre-trim chunk — chunk k's noise keying
        pos0 = k*chunk_out - lat already lands past it)."""
        n = (codes.shape[0] // self._stride if self.wire == "pack24"
             else codes.shape[1])
        take = min(n, self.out_limit - self.written)
        if self.detector is not None and take > 0:
            self.detector.feed(np.asarray(env)[:take].astype(np.float32))
        self._append(codes, 0, take)
        self.written += take
        if self.progress_cb:
            self.progress_cb(min(1.0, self.written / max(self.out_total, 1)))
        return self.written >= self.out_limit

    def emit(self, codes: np.ndarray, env) -> bool:
        """Consume one emitted chunk (``codes`` int codes or packed bytes,
        ``env`` the post-gain float envelope when a detector is active).
        Returns True when the stream is finished (tail detected or
        out_limit reached)."""
        n = (codes.shape[0] // self._stride if self.wire == "pack24"
             else codes.shape[1])
        drop = min(max(0, self.lat - self.g0), n)
        take = min(n - drop, self.out_limit - self.written)
        if self.detector is not None and take > 0:
            fire = self.detector.feed(
                np.asarray(env)[drop : drop + take].astype(np.float32))
            if fire is not None:
                self._append(codes, drop, max(0, fire - self.written))
                self.written = max(self.written, fire)
                if self.progress_cb:
                    self.progress_cb(1.0)
                return True
        self._append(codes, drop, take)
        self.written += take
        self.g0 += n
        if self.progress_cb:
            self.progress_cb(min(1.0, self.written / max(self.out_total, 1)))
        return self.written >= self.out_limit


def _emit_acausal_head(em: _Emitter, lat: int, out_ch: int, seeds_c, gain,
                       cfg, want_env: bool, env_rms: bool, wire,
                       silent) -> bool:
    """Negative measured latency (an acausal chain / caller-supplied
    compensation): the batch `trim_latency` right-shifts with a zero head;
    the streaming twin writes ``|lat|`` frames of dithered digital silence
    at output positions 0..|lat| before the first chunk — same noise
    keying, same wire, same silent-channel zeroing as the chunks (one
    `_finish_step` call on zeros).  Returns True if the stream is already
    complete (out_limit <= |lat|)."""
    d = -int(lat)
    step = _finish_step(jnp.zeros((out_ch, d), jnp.float32), seeds_c,
                        jnp.int32(0), gain, bits=cfg.bits,
                        do_dither=cfg.dither, silent=silent,
                        want_env=want_env, env_rms=env_rms, wire=wire)
    codes, env = step if want_env else (step, None)
    return em.emit_head(np.asarray(codes),
                        np.asarray(env) if env is not None else None)


def stream_resample_file(
    in_path: str,
    out_path: str,
    cfg: ProcessingConfig,
    chunk_seconds: float = 20.0,
    progress_cb=None,
    mesh=None,
    latency_frames: int | None = None,
    noise_floor_db: float | None = None,
) -> int:
    """Public entry: see `_stream_resample_impl` for the full contract.
    This wrapper (a) refuses out==in BEFORE any pre-pass reads the (by
    definition oversized) file, and (b) owns the `.part` temp lifecycle —
    any mid-stream failure (device error, Ctrl-C) removes the partial file
    instead of leaving multi-GB corpses beside deliverables."""
    if os.path.realpath(out_path) == os.path.realpath(in_path):
        raise ValueError(
            f"output path equals the input path ({in_path}); refusing "
            "to destroy the source")
    try:
        return _stream_resample_impl(
            in_path, out_path, cfg, chunk_seconds, progress_cb, mesh,
            latency_frames, noise_floor_db)
    except BaseException:
        try:
            os.unlink(out_path + ".part")
        except OSError:
            pass
        raise


def _stream_resample_impl(
    in_path: str,
    out_path: str,
    cfg: ProcessingConfig,
    chunk_seconds: float = 20.0,
    progress_cb=None,
    mesh=None,
    latency_frames: int | None = None,
    noise_floor_db: float | None = None,
) -> int:
    """Resample ``in_path`` -> ``out_path`` at ``cfg.target_rate`` in constant
    memory.  Returns output frames written.  Output length is exactly
    ceil(in_frames * L / M), matching the whole-file path.

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``frames`` axis — one huge
    file rides all chips: each device step processes a *super-chunk* of
    n_shards chunks sharded over the frames axis; inner shard boundaries
    exchange filter halos over ICI (``ppermute``), while the super-chunk's
    outer halos are read straight from the file (the host-side twin of the
    halo exchange).  Encode stays incremental, so host memory is one
    super-chunk regardless of file length (SURVEY.md section 7 step 6).

    ``cfg.chain``: insert chains stream exactly via per-stage state
    (`Chain.apply_stream`): direct FIR-type stages (EQ, FIR, delays) carry
    their own input-context ring, dynamics (Compressor) carry their envelope
    scan state on the absolute block grid, and partitioned-FFT stages (long
    FIRs / reverb IRs) carry their UPOLS frequency-domain delay line with
    chunks sized to multiples of the FFT block (`Chain.stream_grid`) —
    chunked output is BYTE-identical to the whole-stream chain for every
    built-in stage.  The chain's group delay IS
    trimmed when a latency is supplied (``latency_frames`` argument, e.g.
    the scheduler's calibrated value, or ``cfg.latency_frames``; honoured
    under ``cfg.trim_enabled``): the first ``lat`` emitted frames are
    dropped and chunks keep flowing past the input EOF so the chain's
    ring-out fills the full output length — the streaming form of the batch
    path's ``trim_latency`` shift, with dither keyed by the post-trim
    position so both paths stay on the contract.

    Round 3 lifted the single-chip exclusions (VERDICT round 2 #3): any
    supported container streams in (AIFF via `io.aiff.AiffReader`), channel
    routing / mono fan-out apply per chunk (a host-side gather before the
    SRC — exact, so bytes match the batch graph's on-device routing),
    loudness normalization runs as a two-pass stream (chunk-exact metering
    pre-pass shared with the batch scheduler, so gains are bit-identical),
    latency trim drops the measured delay and consumes the chain ring past
    EOF, and reverb-mode tail detection runs as a host-side incremental
    mirror of the batch detector (`_TailDetector`) — which means, unlike the
    batch path, the INPUT length is unbounded: an hour-long stem streams
    with its tail detected at the end (only the tail itself is capped at
    ``max_tail_seconds``).  The sharded path carries the full feature set
    too (chains / trim / tails run on the sequentially-gathered super-chunk
    stream — `_stream_sharded`).  `streaming_exclusions` is empty for every
    config except one narrow round-4 gate: varispeed ratios combined with
    FFT-convolution chains, whose byte-exact grid alignment would need
    tens-of-megaframe chunks (see `streaming_exclusions`); those route to
    the batch path instead.

    DC-removal ordering: streaming subtracts the SOURCE's whole-file mean
    before SRC+chain (a cheap host pre-pass — the output mean cannot be known
    until the stream has been written), while the batch path removes residual
    DC from the OUTPUT after the chain, as the reference does with its
    capture (Source/MainComponent.cpp:884-902).  For linear chains the two
    differ only by the chain's DC gain on a zero-mean signal (nothing);
    for NONLINEAR stages (saturator, compressor) they genuinely diverge —
    an offset signal saturates asymmetrically.  If that distinction matters,
    match the batch path by disabling ``remove_dc`` here and post-processing,
    or use ``process``.
    """
    excl = streaming_exclusions(cfg, in_path, sharded=mesh is not None)
    if excl:
        raise ValueError(excl[0])
    lat = 0
    if cfg.trim_enabled:
        lat = int(latency_frames if latency_frames is not None
                  else (cfg.latency_frames or 0))
    from ..io import codec

    with codec.open_reader(in_path) as reader:
        rate_in = reader.sample_rate
        bank = design_cycle_bank(rate_in, cfg.target_rate,
                                 quality=cfg.quality, kind=cfg.kind)
        M, W = bank.M, bank.W
        halo_left = bank.pad_front
        halo_right = max(0, W - M - halo_left)  # clamp: heavy lagrange
        # downsampling makes W - M - halo_left negative
        chunk_in = stream_chunk_plan(bank, chunk_seconds, rate_in)
        cycles = chunk_in // M
        T = reader.num_frames
        C_in = reader.num_channels
        out_total = bank.out_len(T)

        # ---- channel routing / mono fan-out (host-side gather at read
        # time: a gather is exact, so values are bit-identical to the batch
        # graph's on-device routing, which also runs BEFORE the SRC) ----
        bound_err = cfg.routing_channel_bound_error(C_in)
        if bound_err:
            raise ValueError(bound_err)   # before any output is written
        routing = (tuple(cfg.channel_routing)
                   if cfg.channel_routing is not None else None)

        def routed(x: np.ndarray) -> np.ndarray:
            if cfg.output_channels and x.shape[0] == 1 \
                    and cfg.output_channels != 1:
                x = np.broadcast_to(x, (cfg.output_channels, x.shape[1]))
            if routing is not None:
                r = np.asarray(routing, np.int32)
                x = np.where((r < 0)[:, None], np.float32(0.0),
                             x[np.where(r < 0, 0, r)])
            return np.ascontiguousarray(x, dtype=np.float32)

        def routed_read(start: int, count: int) -> np.ndarray:
            return routed(reader.read(start, count))

        out_ch = (len(routing) if routing is not None
                  else (cfg.output_channels
                        if (cfg.output_channels and C_in == 1) else C_in))
        silent = (tuple(i for i, r in enumerate(routing) if r < 0)
                  if routing is not None else ())

        # reverb mode: output may extend past the source span by up to the
        # tail cap (the reference's 60 s reverb capture bound,
        # AudioProcessingService.swift:449-452) — but unlike the batch path
        # there is NO input-length cap: an hour-long stem streams through
        # with its tail detected at the end
        reverb = bool(cfg.reverb_mode)
        cap_extra = (int(cfg.max_tail_seconds * cfg.target_rate)
                     if reverb and T > 0 else 0)   # empty input: no tail —
        # without the T guard an empty file would emit cap_extra of silence
        out_limit = out_total + cap_extra

        if cfg.output_format == "aiff":
            # pre-flight: AIFF has no 64-bit container; a >4 GiB projected
            # output must fail NOW, not after hours of writing (WAV output
            # auto-upgrades to RF64 and needs no guard)
            from ..io.aiff import check_aiff_capacity

            check_aiff_capacity(out_limit, out_ch, cfg.bits)

        # ---- loudness-normalization pre-pass: the SOURCE (pre-routing, as
        # the batch scheduler meters the decoded input) through the shared
        # chunk-exact streamed meter, so the gain — and therefore every
        # emitted byte — matches the batch path bit-for-bit.  NOTE: the
        # meter keeps its own default chunk grid; the audio path's
        # chunk_seconds must not leak in, or the measured floats (and the
        # gain) would depend on it.
        norm_gain_db = 0.0
        if cfg.normalize_lufs is not None and T > 0:
            from ..ops.loudness import (meter_source_streamed,
                                        normalization_gain_db,
                                        surround_weights)

            m = meter_source_streamed(
                reader.read, C_in, T, rate_in,
                want_tp=cfg.normalize_tp_db is not None,
                weights=(surround_weights(C_in)
                         if cfg.surround_weights else None))
            if m["lufs"] > -199.0:
                norm_gain_db, _note = normalization_gain_db(
                    cfg.normalize_lufs, m["lufs"], cfg.gain_db,
                    cfg.normalize_tp_db, m["true_peak_db"])

        # total linear gain as ONE traced f32 scalar (per-file gains never
        # recompile); composed exactly as the batch graph composes
        # g_static * gain_lin so the product is the identical float32
        g_static = 10.0 ** (cfg.gain_db / 20.0) if cfg.gain_db else 1.0
        if cfg.normalize_lufs is not None:
            gain_lin = 10.0 ** (np.asarray(norm_gain_db, np.float32) / 20.0)
            gain = jnp.float32(np.float32(g_static) * gain_lin)
        else:
            gain = jnp.float32(g_static)

        # DC pre-pass: whole-file mean per (routed) channel (host, streaming).
        # Accumulate on a FIXED grid, never the audio path's chunk_in: the
        # float64 partial sums associate by block, so a chunk_seconds-sized
        # grid would make the mean (and through it every emitted byte) a
        # function of the chunk size — the same grid-independence rule the
        # streamed loudness meter follows (measured: 1-LSB divergence on a
        # handful of samples between chunk_seconds=0.13 and 0.52).
        mean = np.zeros((out_ch, 1), np.float32)
        if cfg.remove_dc and T > 0:
            DC_GRID = 1 << 20
            acc = np.zeros(out_ch, np.float64)
            pos = 0
            while pos < T:
                blk = routed_read(pos, DC_GRID)
                acc += blk.sum(axis=1)
                pos += blk.shape[1]
            mean = (acc / T).astype(np.float32).reshape(-1, 1)

        # per-file dither seed: derived from (cfg.seed, path) exactly as the
        # batch scheduler does, so the SAME file streamed or batch-processed
        # carries the IDENTICAL dither noise stream (keyed by absolute
        # output frame position: chunk-size invariant — ops/dither.py).
        # Streamed output is byte-identical across chunk sizes, shardings
        # and runs (on the GPU: tools/hw_soak.py, chip_smoke.py phase C).
        # Scope note: XLA:CPU's conv lowering is not shape-invariant for
        # every ratio — different chunk lengths can flip occasional float
        # rounding ties (44.1k->32k measured ~2 frames per 15k under the
        # virtual-device test flag; the fuzz bounds it to <=1 code at <=0.1%
        # of frames).  Versus the BATCH graph the signal under the noise
        # differs at SRC float-rounding level (~3 LSB at 24 bit: the two
        # paths associate the resampler dots differently by design — the
        # tested "dither contract", test_stream_features._assert_dither_contract)
        from ..ops.dither import file_seed

        base_seed = (cfg.seed if cfg.seed is not None
                     else int(time.time()) & 0x7FFFFFFF)
        seed32 = file_seed(base_seed, in_path)
        seeds_c = dither.channel_seeds(jnp.uint32(seed32), out_ch)
        # keep the chunk at least as long as the chain's ring-out — per-stage
        # state rings work at ANY chunk size, but a ring much longer than the
        # chunk would re-convolve its context every chunk (O(ring/chunk)
        # overhead), so GROW the chunk (output is chunk-size invariant,
        # tested).  Hoisted ABOVE the mesh branch: the sharded super-chunk
        # scales with the same chunk_in, so both topologies grow.
        # FFT-convolution stages additionally require chunk_out to be a
        # multiple of the chain's stream grid (the UPOLS block size), so
        # chunk boundaries land on the absolute FFT block grid — the
        # condition for byte-exact streaming of reverb/long-FIR stages
        # (ops/chain.py `Chain.apply_stream`).
        if cfg.chain is not None:
            ring = int(cfg.chain.tail_frames(cfg.target_rate))
            if ring >= cycles * bank.L:
                cycles = ring // bank.L + 1
            g = int(cfg.chain.stream_grid(cfg.target_rate))
            if g > 1:
                import math

                m = g // math.gcd(bank.L, g)   # smallest cycles granule
                cycles = -(-cycles // m) * m
            chunk_in = cycles * bank.M
        # atomic publish: stream into a .part file and os.replace at the end
        # — an incremental writer would otherwise expose a half-written (and,
        # on crash, permanently corrupt) deliverable at the final name
        part = out_path + ".part"
        if mesh is not None:
            n = _stream_sharded(reader, routed_read, out_ch, silent, part,
                                cfg, bank, chunk_in, mesh, mean, seeds_c,
                                gain, progress_cb, lat=lat,
                                noise_floor_db=noise_floor_db)
            _carry_metadata(in_path, part, cfg, rate_in)
            os.replace(part, out_path)
            return n
        carry = (cfg.chain.stream_init(cfg.target_rate, out_ch)
                 if cfg.chain is not None
                 else jnp.zeros((out_ch, 0), jnp.float32))
        detector = None
        if reverb and T > 0:
            gain_total_db = 20.0 * float(np.log10(max(float(gain), 1e-30)))
            nf = (noise_floor_db if noise_floor_db is not None
                  else cfg.noise_floor_db)
            detector = _TailDetector(cfg.target_rate, out_total, cfg,
                                     gain_total_db, nf)
        # D2H wire format (the stream is LINK-bound here): 24-bit codes pack
        # to interleaved bytes on device (3 B/sample; AIFF swaps to BE on the
        # host exactly like the batch `write_aiff_payload` path), 16-bit
        # codes narrow to int16 (2 B/sample).  Bytes on disk are identical
        # to the int32-wire form (the writers pack int32 to the same layout).
        wire = {24: "pack24", 16: "i16"}.get(cfg.bits)
        writer_cls = _WRITERS.get(cfg.output_format, WavWriter)
        with writer_cls(part, out_ch, cfg.target_rate,
                        bits=cfg.bits) as writer:
            # Latency trim (chain group delay): drop the first `lat` emitted
            # frames and keep consuming chunks past the input EOF (zero
            # input; the chain's ring-out comes from the carried SRC-output
            # context) until the full out_total is written — the streaming
            # form of the batch path's trim_latency shift.  Dither noise is
            # keyed by the POST-trim output position (pos0 = g0 - lat),
            # matching the batch path's post-trim indexing bit-for-bit.
            em = _Emitter(writer, detector, lat=lat, out_limit=out_limit,
                          out_total=out_total, progress_cb=progress_cb,
                          wire=wire, channels=out_ch)
            # Varispeed banks: marshal each chunk into overlapping cycle rows
            # on the host (strided window view, ~2% duplicate bytes at NTSC
            # ratios) so the device starts at the segment windows — the
            # streaming twin of the batch scheduler's rows dispatch.
            # Bitwise-identical
            # output: `_banded_core` builds the exact same rows on device.
            from ..ops.resample import (_banded_plan, banded_rows_applicable,
                                        marshal_banded_rows)

            rows_form = banded_rows_applicable(bank)
            if rows_form:
                w_rows = _banded_plan(bank)[3]
                need = (cycles + -(-w_rows // M) - 1) * M

                def marshal_rows(flat: np.ndarray) -> np.ndarray:
                    if flat.shape[1] < need:
                        flat = np.pad(flat,
                                      ((0, 0), (0, need - flat.shape[1])))
                    return marshal_banded_rows(flat, bank, n_rows=cycles)

            def read_chunk(start: int) -> np.ndarray:
                # chunk input span incl. halos, zero-padded at the ends
                lo = start - halo_left
                hi = start + chunk_in + halo_right
                span = routed_read(max(0, lo), hi - max(0, lo))
                # subtract the whole-file mean from REAL samples only, before
                # zero padding: subtracting after padding would put a -mean
                # step into the halo regions and smear an edge transient
                # through the filter at the file head/tail
                if cfg.remove_dc:
                    span = span - mean
                pad_l = max(0, -lo)
                pad_r = (hi - lo) - pad_l - span.shape[1]
                xp = np.pad(span, ((0, 0), (pad_l, max(0, pad_r))))
                return marshal_rows(xp) if rows_form else xp

            # ---- raw H2D upload wire: integer-PCM
            # sources ship their container bytes (3 B/sample at 24 bit,
            # 2 B at 16) and decode/fan-out/route/DC-subtract ON DEVICE —
            # bitwise-identical floats (power-of-two scaling, same op order
            # as the host `routed()` + pre-pass).  Varispeed rows marshal
            # on the host, so the rows form keeps the float wire.
            in_wire = (getattr(reader, "raw_wire", lambda: None)()
                       if not rows_form else None)
            fanout_n = (cfg.output_channels
                        if (cfg.output_channels and C_in == 1
                            and cfg.output_channels != 1) else 0)
            mean_dev = (jnp.asarray(mean)
                        if (cfg.remove_dc and in_wire is not None) else None)
            bpf_in = C_in * (in_wire[0] // 8) if in_wire is not None else 0

            def read_chunk_raw(start: int):
                lo = start - halo_left
                hi = start + chunk_in + halo_right
                span_b = reader.read_raw(max(0, lo), hi - max(0, lo))
                pad_l = max(0, -lo)
                buf = np.zeros((hi - lo) * bpf_in, np.uint8)
                buf[pad_l * bpf_in : pad_l * bpf_in + span_b.size] = span_b
                # [a, b): the span's REAL frame range (the device's DC-mean
                # mask — zero-padded halos must stay exactly zero)
                return buf, pad_l, pad_l + span_b.size // bpf_in

            def dispatch(k: int):
                # chunk geometry is deterministic: chunk k reads input at
                # k*chunk_in and emits output positions k*chunk_out - lat
                # (em.g0 == k*chunk_out when chunk k is next to emit), so
                # dispatch can run AHEAD of emission — see the pipeline note
                # below.  `carry` (the chain's device-side state) threads
                # through dispatch order, which JAX serialises for us.
                nonlocal carry
                if in_wire is not None:
                    buf, a, b = read_chunk_raw(k * chunk_in)
                    xarg = jnp.asarray(buf)
                    extra = dict(in_wire=in_wire, in_channels=C_in,
                                 fanout=fanout_n, routing=routing)
                    if mean_dev is not None:
                        extra.update(mean=mean_dev, valid_lo=jnp.int32(a),
                                     valid_hi=jnp.int32(b))
                else:
                    xarg = jnp.asarray(read_chunk(k * chunk_in))
                    extra = {}
                step = _stream_step(
                    xarg, carry, seeds_c,
                    jnp.int32(k * chunk_out - lat), gain,
                    cycles=cycles, rate_in=rate_in, rate_out=cfg.target_rate,
                    quality=cfg.quality, kind=cfg.kind, bits=cfg.bits,
                    do_dither=cfg.dither,
                    chain=cfg.chain, chain_pos=jnp.int32(k * chunk_out),
                    silent=silent, want_env=detector is not None,
                    env_rms=(detector is not None
                             and cfg.tail_mode == "rms"),
                    rows_form=rows_form, wire=wire, **extra,
                )
                if detector is not None:
                    codes, env, carry = step
                    return codes, env
                (codes, carry), env = step, None
                return codes, env

            # ---- one-deep software pipeline: dispatch chunk k (async H2D +
            # compute under JAX's dispatch queue), THEN materialise and write
            # chunk k-1 — the host read/pad/marshal and the encode/disk write
            # overlap the device/link work instead of serialising with it.
            # Inputs,
            # positions, and the carry chain are identical to the serial
            # loop, so output bytes are unchanged (tested contracts: batch
            # parity, chunk-size invariance).  Without a tail detector the
            # chunk count is exact (no wasted dispatch); in reverb mode the
            # stream length is data-dependent, so at most ONE in-flight
            # chunk is discarded when the detector fires.
            chunk_out = cycles * bank.L
            n_chunks = (None if detector is not None
                        else -(-(out_limit + lat) // chunk_out))
            k = 0
            pending = None
            done = out_limit == 0
            if lat < 0 and not done:
                # acausal chain compensation: dithered zero head first
                done = _emit_acausal_head(
                    em, lat, out_ch, seeds_c, gain, cfg,
                    detector is not None,
                    detector is not None and cfg.tail_mode == "rms",
                    wire, silent)
            while not done:
                nxt = (dispatch(k)
                       if (n_chunks is None or k < n_chunks) else None)
                k += 1
                if pending is not None:
                    done = em.emit(np.asarray(pending[0]), pending[1])
                elif nxt is None:
                    break       # defensive: nothing in flight, nothing left
                if not done:
                    pending = nxt
        _carry_metadata(in_path, part, cfg, rate_in)
        os.replace(part, out_path)
        return em.written


def _carry_metadata(in_path: str, out_path: str, cfg, rate_in: int) -> None:
    """Best-effort --keep-metadata for the streaming path: the ONE shared
    rule (`io.codec.carry_metadata`), swallowed here because the stream has
    no per-file status log (the audio is complete by this point)."""
    if not cfg.keep_metadata:
        return
    from ..io.codec import carry_metadata

    try:
        carry_metadata(in_path, out_path, cfg.output_format, rate_in,
                       cfg.target_rate)
    except (ValueError, OSError, MemoryError):
        pass      # metadata is best-effort; the audio is complete


@functools.partial(jax.jit, static_argnames=("rate_in", "rate_out",
                                             "quality", "kind"))
def _banded_rows_sharded_step(rows, *, rate_in, rate_out, quality, kind):
    """Varispeed SRC on a rows-marshalled super-chunk ``(C, Q, w_rows)``
    sharded over the cycle axis.  Cycle rows carry their own overlap, so —
    unlike the flat overlap-save path — there is NO halo exchange at all:
    every shard's dots are self-contained and XLA partitions the einsums as
    a plain batch dimension (zero collectives).  Output ``(C, Q*L)`` stays
    sharded over the merged frames axis for the downstream elementwise
    stages.  Bitwise-identical to the single-chip rows form (the marshalled
    windows and matrices are the same arrays through `_banded_eval_rows`)."""
    from ..ops.resample import resample_banded_rows_pre

    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    y = resample_banded_rows_pre(rows, bank)            # (C, Q, L)
    return y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1])


@functools.partial(jax.jit, static_argnames=("bits", "do_dither", "silent",
                                             "want_env", "env_rms", "wire"))
def _finish_step(y, seeds_c, pos0, gain, *, bits, do_dither, silent=None,
                 want_env=False, env_rms=False, wire=None):
    """Gain + dither/quantize (+ silent-channel zeroing + the narrow D2H
    wire) on the (sharded) resampled super-chunk — delegates to the ONE
    `_finish_chunk` body (chain=None), so the sharded no-chain tail runs the
    SAME ops as the single-chip loop.  XLA partitions the elementwise ops
    (and the position iota) along the existing frames sharding, so each
    shard hashes its own positions.  ``gain`` is a traced f32 scalar
    (static x normalization gain).  ``want_env``: also return the pre-dither
    loudest-channel envelope for the reverb-tail detector."""
    out = _finish_chunk(y, None, seeds_c, pos0, gain, rate_out=0, bits=bits,
                        do_dither=do_dither, chain=None, silent=silent,
                        want_env=want_env, env_rms=env_rms, wire=wire)
    if want_env:
        codes, env, _ = out
        return codes, env
    return out[0]


@functools.partial(jax.jit, static_argnames=("mesh", "in_wire", "in_channels",
                                             "fanout", "routing", "has_mean"))
def _decode_span_sharded(raw, mean, valid_lo, valid_hi, *, mesh, in_wire,
                         in_channels, fanout=0, routing=None, has_mean=False):
    """Raw H2D wire for the sharded stream (the round-3e single-chip wire
    surgery, ported per VERDICT r3 #3): the super-chunk's container BYTES
    arrive sharded over the frames axis (byte index = frame * bpf, so an
    even byte split lands on frame boundaries) and each shard decodes /
    fans out / routes / DC-subtracts ITS chunk locally through the SAME
    `_raw_front` the single-chip `_stream_step` traces — zero collectives,
    bitwise-identical floats.  Returns (C, super_in) float32 still sharded
    over frames for `resample_frames_sharded`."""
    from jax.sharding import PartitionSpec as P

    def local(rc, mn, lo, hi):
        frames_local = rc.shape[-1] // (in_channels * (in_wire[0] // 8))
        off = jax.lax.axis_index("frames").astype(jnp.int32) * frames_local
        return _raw_front(rc, in_wire=in_wire, in_channels=in_channels,
                          fanout=fanout, routing=routing,
                          mean=mn if has_mean else None,
                          valid_lo=lo, valid_hi=hi, idx_offset=off)

    rep = P()
    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P("frames"), P(None, None), rep, rep),
                         out_specs=P(None, "frames"))(
        raw, mean, valid_lo, valid_hi)


def _stream_sharded(reader, routed_read, out_ch, silent, out_path, cfg, bank,
                    chunk_in, mesh, mean, seeds_c, gain, progress_cb,
                    lat=0, noise_floor_db=None) -> int:
    """Multi-chip streaming body: super-chunks of n_shards*chunk_in frames,
    frames axis sharded over the mesh, file-context outer halos.

    Feature-complete with the single-chip stream: the host consumes the
    emitted super-chunks in file order, so the sequential stages run exactly
    as they do single-chip — insert chains via `_chain_finish_step` (the
    gathered super-chunk is just a bigger streaming chunk; chain output is
    chunk-size invariant, so bytes match), latency trim by dropping the
    first ``lat`` emitted frames while chunks keep flowing past the input
    EOF, and reverb-mode tails via the same incremental `_TailDetector`.

    Round 4 (VERDICT r3 #3) ports the round-3e single-chip wire surgery:
    integer-PCM sources ship container BYTES sharded over the frames axis
    and decode on device (`_decode_span_sharded` — zero collectives,
    bitwise-identical floats), the D2H download packs 24-bit codes to
    interleaved bytes / narrows 16-bit to int16 on device (the same
    `_finish_chunk` wire the single-chip loop uses), and a one-deep
    software pipeline overlaps the host read/encode of super-chunk k-1
    with the device work of chunk k (chunk geometry is deterministic, so
    inputs and bytes are unchanged; in reverb mode at most ONE in-flight
    super-chunk is discarded when the detector fires).  With a chain the
    host gather of the SRC output serialises the pipeline's compute overlap
    (the narrow wires still apply)."""
    from ..parallel.sharding import resample_frames_sharded, shard_halos

    n = mesh.shape["frames"]
    if n < 2:
        raise ValueError("mesh has no frames axis to shard over")
    rate_in = reader.sample_rate
    halo_left, halo_right = shard_halos(bank)
    if max(halo_left, halo_right) > chunk_in:
        raise ValueError(
            f"chunk of {chunk_in} frames is smaller than the filter halo "
            f"({max(halo_left, halo_right)}); raise chunk_seconds")
    super_in = n * chunk_in
    super_out = (super_in // bank.M) * bank.L
    T = reader.num_frames
    out_total = bank.out_len(T)
    C = out_ch

    reverb = bool(cfg.reverb_mode)
    cap_extra = (int(cfg.max_tail_seconds * cfg.target_rate)
                 if reverb and T > 0 else 0)
    out_limit = out_total + cap_extra
    detector = None
    if reverb and T > 0:
        gain_total_db = 20.0 * float(np.log10(max(float(gain), 1e-30)))
        nf = (noise_floor_db if noise_floor_db is not None
              else cfg.noise_floor_db)
        detector = _TailDetector(cfg.target_rate, out_total, cfg,
                                 gain_total_db, nf)
    if cfg.chain is not None:
        ring = int(cfg.chain.tail_frames(cfg.target_rate))
        if ring >= super_out:
            raise ValueError(
                f"chain ring-out ({ring} frames) exceeds one "
                f"sharded super-chunk ({super_out}); raise chunk_seconds")
        carry = cfg.chain.stream_init(cfg.target_rate, C)
    else:
        carry = jnp.zeros((C, 0), jnp.float32)

    def read_span(lo: int, length: int) -> np.ndarray:
        """(C, length) float32, zero-padded outside [0, T), DC-corrected."""
        out = np.zeros((C, length), np.float32)
        a = max(0, lo)
        b = min(T, lo + length)
        if b > a:
            blk = routed_read(a, b - a)
            if cfg.remove_dc:
                blk = blk - mean
            out[:, a - lo : a - lo + blk.shape[1]] = blk
        return out

    # Varispeed banks: marshal the super-chunk into cycle rows on the host
    # and shard the CYCLE axis — rows carry their own overlap, so the
    # banded einsums partition with ZERO collectives (no ppermute halos),
    # and the output is bitwise-identical to the single-chip rows form.
    from ..ops.resample import (_banded_plan, banded_rows_applicable,
                                marshal_banded_rows)

    rows_form = banded_rows_applicable(bank)
    if rows_form:
        from jax.sharding import NamedSharding, PartitionSpec

        w_rows = _banded_plan(bank)[3]
        Qc = super_in // bank.M                 # n * cycles: shards evenly
        rows_need = (Qc + -(-w_rows // bank.M) - 1) * bank.M
        rows_sharding = NamedSharding(
            mesh, PartitionSpec(None, "frames", None))

    # ---- wire formats (the round-3e surgery, shared with the single-chip
    # loop so bytes on disk are identical): narrow D2H always; raw H2D for
    # integer-PCM sources on the flat form (varispeed rows marshal floats
    # on the host, so the rows form keeps the float wire) ----
    wire = {24: "pack24", 16: "i16"}.get(cfg.bits)
    in_wire = (getattr(reader, "raw_wire", lambda: None)()
               if not rows_form else None)
    if in_wire is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        C_in = reader.num_channels
        routing_t = (tuple(cfg.channel_routing)
                     if cfg.channel_routing is not None else None)
        fanout_n = (cfg.output_channels
                    if (cfg.output_channels and C_in == 1
                        and cfg.output_channels != 1) else 0)
        bpf_in = C_in * (in_wire[0] // 8)
        byte_sharding = NamedSharding(mesh, PartitionSpec("frames"))
        mean_dev = jnp.asarray(mean)

        def read_raw_span(lo: int):
            """Container bytes for [lo, lo+super_in), zero-padded past EOF;
            returns (buffer, first-real-frame, past-last-real-frame) in
            span-relative coordinates (lo >= 0 always on this path)."""
            buf = np.zeros(super_in * bpf_in, np.uint8)
            if lo < T:
                span_b = reader.read_raw(lo, min(T, lo + super_in) - lo)
                buf[: span_b.size] = span_b
                return buf, 0, span_b.size // bpf_in
            return buf, 0, 0

    want_env = detector is not None
    env_rms = want_env and cfg.tail_mode == "rms"
    silent_t = tuple(silent) if silent else None

    writer_cls = _WRITERS.get(cfg.output_format, WavWriter)
    with writer_cls(out_path, C, cfg.target_rate, bits=cfg.bits) as writer:
        em = _Emitter(writer, detector, lat=lat, out_limit=out_limit,
                      out_total=out_total, progress_cb=progress_cb,
                      wire=wire, channels=C)

        def dispatch(k: int):
            # super-chunk geometry is deterministic (chunk k reads input at
            # k*super_in and emits pre-trim output positions k*super_out),
            # so dispatch can run one step AHEAD of emission — the same
            # one-deep pipeline as the single-chip loop.  `carry` (the
            # chain's state pytree) threads through dispatch order.
            nonlocal carry
            start = k * super_in
            if rows_form:
                flatbuf = read_span(start - bank.pad_front, rows_need)
                rows = marshal_banded_rows(flatbuf, bank, n_rows=Qc)
                y = _banded_rows_sharded_step(
                    jax.device_put(rows, rows_sharding),
                    rate_in=rate_in, rate_out=cfg.target_rate,
                    quality=cfg.quality, kind=cfg.kind)
            else:
                if in_wire is not None:
                    buf, a, b = read_raw_span(start)
                    x = _decode_span_sharded(
                        jax.device_put(buf, byte_sharding), mean_dev,
                        jnp.int32(a), jnp.int32(b), mesh=mesh,
                        in_wire=in_wire, in_channels=C_in, fanout=fanout_n,
                        routing=routing_t, has_mean=bool(cfg.remove_dc))
                else:
                    x = jnp.asarray(read_span(start, super_in))
                left = read_span(start - halo_left, halo_left)
                right = read_span(start + super_in, halo_right)
                y = resample_frames_sharded(
                    x, rate_in, cfg.target_rate, mesh,
                    quality=cfg.quality, kind=cfg.kind,
                    left_halo=jnp.asarray(left), right_halo=jnp.asarray(right))
            if cfg.chain is not None:
                step = _chain_finish_step(
                    jnp.asarray(np.asarray(y)), carry, seeds_c,
                    jnp.int32(k * super_out - lat), gain,
                    rate_out=cfg.target_rate,
                    bits=cfg.bits, do_dither=cfg.dither, chain=cfg.chain,
                    chain_pos=jnp.int32(k * super_out), silent=silent_t,
                    want_env=want_env, env_rms=env_rms, wire=wire)
                if want_env:
                    codes, env, carry = step
                else:
                    (codes, carry), env = step, None
                return codes, env
            step = _finish_step(
                y, seeds_c, jnp.int32(k * super_out - lat), gain,
                bits=cfg.bits, do_dither=cfg.dither, silent=silent_t,
                want_env=want_env, env_rms=env_rms, wire=wire)
            if want_env:
                codes, env = step
                return codes, env
            return step, None

        n_super = (None if detector is not None
                   else -(-(out_limit + lat) // super_out))
        k = 0
        pending = None
        done = out_limit == 0
        if lat < 0 and not done:
            # acausal chain compensation: dithered zero head first
            done = _emit_acausal_head(em, lat, C, seeds_c, gain, cfg,
                                      want_env, env_rms, wire, silent_t)
        while not done:
            nxt = (dispatch(k)
                   if (n_super is None or k < n_super) else None)
            k += 1
            if pending is not None:
                done = em.emit(np.asarray(pending[0]), pending[1])
            elif nxt is None:
                break       # defensive: nothing in flight, nothing left
            if not done:
                pending = nxt
    return em.written
