"""Round-3 streaming feature parity (VERDICT r2 #3): channel routing /
mono fan-out and AIFF input on the streaming path, each checked against the
batch path under the dither contract (identical noise keying; differences
bounded at SRC-rounding level)."""

from __future__ import annotations

import os

import numpy as np
import pytest

from f9tpu.config import ProcessingConfig
from f9tpu.io import read_wav, write_wav
from f9tpu.io.aiff import AiffReader, read_aiff, write_aiff
from f9tpu.pipeline import BatchProcessor, stream_resample_file


def _code_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.round(a * (1 << 23)) - np.round(b * (1 << 23))


def _assert_dither_contract(a, b, max_codes=16, max_frac=0.35):
    d = _code_diff(a, b)
    assert np.abs(d).max() <= max_codes
    assert (d != 0).mean() < max_frac


class TestStreamRouting:
    def test_routing_with_silence_matches_batch(self, tmp_path):
        rate = 44100
        rng = np.random.default_rng(5)
        x = (0.3 * rng.standard_normal((4, rate + 997))).astype(np.float32)
        src = str(tmp_path / "bus.wav")
        write_wav(src, x, rate, bits=24)

        routing = [2, -1, 0, 1]   # reorder + one silent output channel
        cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                               target_rate=48000, quality="low", seed=7,
                               remove_dc=False, channel_routing=routing)
        assert BatchProcessor(cfg).run([src]).completed == 1
        sp = str(tmp_path / "routed_stream.wav")
        n = stream_resample_file(src, sp, cfg, chunk_seconds=0.3)

        yb, _ = read_wav(str(tmp_path / "out" / "bus_processed.wav"))
        ys, _ = read_wav(sp)
        assert ys.shape[0] == 4 and yb.shape == ys.shape
        # silent channel is digital zero on BOTH paths, even under dither
        assert np.all(yb[1] == 0.0) and np.all(ys[1] == 0.0)
        _assert_dither_contract(yb, ys)
        assert n == ys.shape[1]

    def test_routing_chunk_size_invariant(self, tmp_path):
        rate = 48000
        rng = np.random.default_rng(6)
        x = (0.2 * rng.standard_normal((2, rate // 2 + 333))).astype(np.float32)
        src = str(tmp_path / "st.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=44100,
                               quality="low", seed=3, remove_dc=False,
                               channel_routing=[1, 0])
        o1, o2 = str(tmp_path / "r1.wav"), str(tmp_path / "r2.wav")
        stream_resample_file(src, o1, cfg, chunk_seconds=0.11)
        stream_resample_file(src, o2, cfg, chunk_seconds=0.37)
        y1, _ = read_wav(o1)
        y2, _ = read_wav(o2)
        np.testing.assert_array_equal(y1, y2)
        # routing actually swapped the channels: compare against unrouted run
        cfg0 = ProcessingConfig(output_dir=str(tmp_path), target_rate=44100,
                                quality="low", seed=3, remove_dc=False)
        o0 = str(tmp_path / "r0.wav")
        stream_resample_file(src, o0, cfg0, chunk_seconds=0.11)
        y0, _ = read_wav(o0)
        # channel 0 of the routed run carries source channel 1's audio (the
        # dither streams differ by design — they are keyed by the OUTPUT
        # channel — so compare correlation, not bytes)
        c = np.corrcoef(y1[0], y0[1])[0, 1]
        assert c > 0.9999

    def test_mono_fanout_matches_batch(self, tmp_path):
        rate = 44100
        rng = np.random.default_rng(8)
        x = (0.25 * rng.standard_normal((1, rate + 41))).astype(np.float32)
        src = str(tmp_path / "mono.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                               target_rate=48000, quality="low", seed=5,
                               remove_dc=False, output_channels=2)
        assert BatchProcessor(cfg).run([src]).completed == 1
        sp = str(tmp_path / "fan_stream.wav")
        stream_resample_file(src, sp, cfg, chunk_seconds=0.3)
        yb, _ = read_wav(str(tmp_path / "out" / "mono_processed.wav"))
        ys, _ = read_wav(sp)
        assert yb.shape[0] == 2 and ys.shape[0] == 2
        _assert_dither_contract(yb, ys)
        # the two fanned-out channels carry the same audio but INDEPENDENT
        # dither streams (per-channel noise keying)
        assert not np.array_equal(ys[0], ys[1])
        _assert_dither_contract(ys[0], ys[1], max_frac=1.01, max_codes=3)


class TestStreamAiffInput:
    def _make_aiff(self, tmp_path, channels=2, frames=44100 + 517,
                   rate=44100):
        rng = np.random.default_rng(9)
        x = (0.3 * rng.standard_normal((channels, frames))).astype(np.float32)
        src = str(tmp_path / "in.aiff")
        write_aiff(src, x, rate, bits=24)
        return src, x

    def test_aiff_reader_matches_whole_file_decode(self, tmp_path):
        src, _ = self._make_aiff(tmp_path)
        whole, rate = read_aiff(src)
        with AiffReader(src) as r:
            assert (r.num_channels, r.sample_rate) == (2, 44100)
            assert r.num_frames == whole.shape[1]
            # arbitrary windows decode identically to the whole-file reader
            for start, count in [(0, 100), (517, 4096), (44000, 10_000),
                                 (whole.shape[1] - 3, 50)]:
                got = r.read(start, count)
                want = whole[:, start : start + count]
                np.testing.assert_array_equal(got, want)

    def test_aiff_streams_and_matches_batch(self, tmp_path):
        src, _ = self._make_aiff(tmp_path)
        cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                               target_rate=48000, quality="low", seed=4,
                               remove_dc=False)
        assert BatchProcessor(cfg).run([src]).completed == 1
        sp = str(tmp_path / "aiff_stream.wav")
        n = stream_resample_file(src, sp, cfg, chunk_seconds=0.3)
        yb, _ = read_wav(str(tmp_path / "out" / "in_processed.wav"))
        ys, _ = read_wav(sp)
        assert yb.shape == ys.shape and n == ys.shape[1]
        _assert_dither_contract(yb, ys)

    def test_sowt_aiff_reader(self, tmp_path):
        # little-endian AIFC: build via the raw helper then read back
        from f9tpu.io.aiff import _write_extended80
        import struct

        rng = np.random.default_rng(10)
        codes = (rng.integers(-(1 << 15), 1 << 15, (2, 2048))
                 .astype(np.int32))
        inter = np.ascontiguousarray(codes.T).reshape(-1).astype("<i2")
        payload = inter.tobytes()
        comm = (struct.pack(">hIh", 2, 2048, 16)
                + _write_extended80(44100.0) + b"sowt"
                + struct.pack(">B", 0) + b"\x00")
        ssnd = struct.pack(">II", 0, 0) + payload
        body = (b"AIFC"
                + b"COMM" + struct.pack(">I", len(comm)) + comm
                + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
        src = str(tmp_path / "sowt.aiff")
        with open(src, "wb") as f:
            f.write(b"FORM" + struct.pack(">I", len(body)) + body)
        with AiffReader(src) as r:
            x = r.read(0, 2048)
        np.testing.assert_allclose(x * 32768.0, codes, atol=0.5)


class TestStreamLatencyTrim:
    def test_chain_delay_trim_matches_batch(self, tmp_path):
        """Round-3 lifted exclusion: streaming honors latency trim — drop
        the measured delay's frames from the front, keep consuming the
        chain ring past EOF until the full output length is written.  With
        the same explicit latency, batch and stream agree at the dither
        contract level (noise keyed by POST-trim position on both paths)."""
        from f9tpu.ops.chain import Chain, Delay

        rate = 48000
        rng = np.random.default_rng(12)
        x = (0.3 * rng.standard_normal((2, rate + 123))).astype(np.float32)
        src = str(tmp_path / "dly.wav")
        write_wav(src, x, rate, bits=24)

        delay_s = 0.01                      # 441 output frames at 44.1k
        lat = int(round(delay_s * 44100))
        cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                               target_rate=44100, quality="low", seed=6,
                               remove_dc=False,
                               chain=Chain(Delay(delay_s)),
                               latency_frames=lat)
        assert BatchProcessor(cfg).run([src]).completed == 1
        sp = str(tmp_path / "dly_stream.wav")
        n = stream_resample_file(src, sp, cfg, chunk_seconds=0.3)

        yb, _ = read_wav(str(tmp_path / "out" / "dly_processed.wav"))
        ys, _ = read_wav(sp)
        assert yb.shape == ys.shape and n == ys.shape[1]
        _assert_dither_contract(yb, ys)
        # the trim genuinely removed the delay: output correlates with the
        # plain (no-chain, no-trim) stream at lag 0
        cfg0 = ProcessingConfig(output_dir=str(tmp_path), target_rate=44100,
                                quality="low", seed=6, remove_dc=False)
        o0 = str(tmp_path / "plain.wav")
        stream_resample_file(src, o0, cfg0, chunk_seconds=0.3)
        y0, _ = read_wav(o0)
        m = min(y0.shape[1], ys.shape[1]) - lat
        c = np.corrcoef(ys[0, :m], y0[0, :m])[0, 1]
        assert c > 0.999, c

    def test_latency_trim_chunk_size_invariant(self, tmp_path):
        rate = 44100
        rng = np.random.default_rng(13)
        x = (0.2 * rng.standard_normal((1, rate // 2))).astype(np.float32)
        src = str(tmp_path / "l.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=2, remove_dc=False,
                               latency_frames=100)
        o1, o2 = str(tmp_path / "l1.wav"), str(tmp_path / "l2.wav")
        stream_resample_file(src, o1, cfg, chunk_seconds=0.07)
        stream_resample_file(src, o2, cfg, chunk_seconds=0.29)
        a = open(o1, "rb").read()
        b = open(o2, "rb").read()
        assert a == b


class TestStreamReverbTail:
    def _hit_with_reverb(self, tmp_path, rate=44100, seconds=1.0):
        rng = np.random.default_rng(30)
        t = np.arange(int(seconds * rate)) / rate
        hit = (0.4 * np.sin(2 * np.pi * 220 * t)
               * np.exp(-t * 8)).astype(np.float32)
        src = str(tmp_path / "hit.wav")
        write_wav(src, np.stack([hit, hit]), rate, bits=24)
        ir_len = 12000
        tt = np.arange(ir_len) / 48000
        ir = np.zeros(ir_len, np.float32)
        ir[0] = 1.0
        ir[1:] = (0.05 * rng.standard_normal(ir_len - 1)
                  * np.exp(-tt[1:] / 0.05)).astype(np.float32)
        return src, ir

    def test_reverb_tail_streams_and_matches_batch_length(self, tmp_path):
        """Round 3: reverb-mode tail detection streams (host-side
        incremental mirror of detect_tail_end).  The tail extends past the
        source span, terminates at the noise floor, and the detected end
        lands on the same hop grid as the batch path (within one hop of
        the batch's detected end — levels at the threshold differ only at
        SRC-rounding level between the two execution paths)."""
        from f9tpu.ops.chain import Chain, ConvolutionReverb

        src, ir = self._hit_with_reverb(tmp_path)
        cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                               target_rate=48000, quality="low", seed=9,
                               remove_dc=False, reverb_mode=True,
                               noise_floor_db=-85.0,
                               chain=Chain(ConvolutionReverb(ir, wet=0.6,
                                                             dry=0.4)))
        res = BatchProcessor(cfg).run([src])
        assert res.completed == 1
        batch_frames = res.per_file[src]["out_frames"]

        sp = str(tmp_path / "hit_stream.wav")
        n = stream_resample_file(src, sp, cfg, chunk_seconds=0.25)
        src_span = 48000  # 1 s at the output rate
        assert n > src_span, "tail must extend past the source"
        hop = 48000 * cfg.tail_hop_ms // 1000
        assert abs(n - batch_frames) <= hop, (n, batch_frames)
        ys, rs = read_wav(sp)
        assert rs == 48000 and ys.shape[1] == n
        # tail region is genuinely below the threshold at the end
        tail_db = 20 * np.log10(np.abs(ys[:, -hop:]).max() + 1e-30)
        assert tail_db < -85.0

    def test_reverb_no_chain_ends_at_hop_grid(self, tmp_path):
        src, _ = self._hit_with_reverb(tmp_path)
        cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                               target_rate=48000, quality="low", seed=9,
                               remove_dc=False, reverb_mode=True,
                               noise_floor_db=-85.0)
        res = BatchProcessor(cfg).run([src])
        batch_frames = res.per_file[src]["out_frames"]
        sp = str(tmp_path / "nochain_stream.wav")
        n = stream_resample_file(src, sp, cfg, chunk_seconds=0.3)
        hop = 48000 * cfg.tail_hop_ms // 1000
        assert abs(n - batch_frames) <= hop, (n, batch_frames)

    def test_reverb_tail_detects_at_16_bit_dithered(self, tmp_path):
        """Regression: the stream detector must measure the PRE-dither float
        envelope (as the batch detect_tail_end does).  At 16 bits the TPDF
        dither floor's 100 ms window peak (~ -90 dBFS) sits ABOVE an
        -85 dB-derived threshold (-93.5 dB at 10% margin); a detector fed
        the dequantized codes could never see a quiet window and the stream
        would emit the full max_tail_seconds cap of dither noise."""
        src, _ = self._hit_with_reverb(tmp_path)
        cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                               target_rate=48000, quality="low", seed=9,
                               remove_dc=False, reverb_mode=True, bits=16,
                               dither=True, noise_floor_db=-85.0,
                               max_tail_seconds=2.0)
        res = BatchProcessor(cfg).run([src])
        assert res.completed == 1
        batch_frames = res.per_file[src]["out_frames"]
        sp = str(tmp_path / "s16.wav")
        n = stream_resample_file(src, sp, cfg, chunk_seconds=0.3)
        hop = 48000 * cfg.tail_hop_ms // 1000
        assert abs(n - batch_frames) <= hop, (n, batch_frames)
        assert n < 48000 + 48000, "must terminate well before the tail cap"

    def test_reverb_stream_chunk_size_invariant(self, tmp_path):
        from f9tpu.ops.chain import Chain, ConvolutionReverb

        src, ir = self._hit_with_reverb(tmp_path)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=9, remove_dc=False,
                               reverb_mode=True, noise_floor_db=-85.0,
                               chain=Chain(ConvolutionReverb(ir, wet=0.6,
                                                             dry=0.4)))
        o1, o2 = str(tmp_path / "rv1.wav"), str(tmp_path / "rv2.wav")
        n1 = stream_resample_file(src, o1, cfg, chunk_seconds=0.31)
        n2 = stream_resample_file(src, o2, cfg, chunk_seconds=0.62)
        assert n1 == n2
        # round 4: the reverb's UPOLS delay line is carried as stage state
        # on the ABSOLUTE block grid (chunks are sized to multiples of the
        # FFT block), so even FFT chains are now bitwise chunk-invariant —
        # this was the last rounding-level exception
        assert open(o1, "rb").read() == open(o2, "rb").read()

    def test_never_quiet_tail_hits_cap(self, tmp_path):
        rate = 8000
        rng = np.random.default_rng(31)
        x = (0.3 * rng.standard_normal((1, rate))).astype(np.float32)
        src = str(tmp_path / "noise.wav")
        write_wav(src, x, rate, bits=24)
        from f9tpu.ops.chain import Chain, FIRInsert

        # an (unrealistic) lossless feed-forward: tail is pure dither floor
        # BELOW any threshold — use a noise floor of -300 that never fires
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=8000,
                               quality="low", seed=1, remove_dc=False,
                               reverb_mode=True, noise_floor_db=-300.0,
                               max_tail_seconds=0.5, dither=False)
        sp = str(tmp_path / "cap_stream.wav")
        n = stream_resample_file(src, sp, cfg, chunk_seconds=0.2)
        assert n == rate + int(0.5 * 8000)   # src span + tail cap

    def test_empty_input_reverb_writes_nothing(self, tmp_path):
        src = str(tmp_path / "empty.wav")
        write_wav(src, np.zeros((2, 0), np.float32), 44100, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=1, reverb_mode=True,
                               noise_floor_db=-85.0)
        sp = str(tmp_path / "empty_out.wav")
        n = stream_resample_file(src, sp, cfg, chunk_seconds=0.2)
        assert n == 0
        y, _ = read_wav(sp)
        assert y.shape[1] == 0


class TestShardedStreamFeatures:
    """Round 3's last lifted exclusions: insert chains, latency trim, and
    reverb-mode tails on the SHARDED streaming path.  The sharded stream
    emits super-chunks in file order, so the sequential stages (chain
    continuation / trim / tail detection) run exactly as single-chip —
    when the single-chip chunk is sized to equal the sharded super-chunk,
    the two paths execute the identical op sequence and bytes match."""

    def test_chain_and_trim_bytes_match_single_chip(self, tmp_path):
        from f9tpu.parallel import make_mesh
        from f9tpu.ops.chain import Chain, Delay

        rate_in, rate_out = 44100, 48000
        rng = np.random.default_rng(21)
        x = (0.3 * rng.standard_normal((2, int(1.3 * rate_in)))
             ).astype(np.float32)
        src = str(tmp_path / "ch.wav")
        write_wav(src, x, rate_in, bits=24)

        lat = int(round(0.01 * rate_out))
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=rate_out,
                               quality="low", seed=11, remove_dc=False,
                               chain=Chain(Delay(0.01)), latency_frames=lat)
        # single-chip chunk (0.4 s) == 4-shard super-chunk of 0.1 s chunks
        # (44100*0.1 // 147 = 30 cycles -> x4 = the 0.4 s plan's 120), so
        # the chain sees identical buffer lengths and bytes must MATCH
        o1 = str(tmp_path / "single.wav")
        n1 = stream_resample_file(src, o1, cfg, chunk_seconds=0.4)
        mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
        o2 = str(tmp_path / "sharded.wav")
        n2 = stream_resample_file(src, o2, cfg, chunk_seconds=0.1, mesh=mesh)
        assert n1 == n2
        assert open(o1, "rb").read() == open(o2, "rb").read()

    def test_reverb_tail_sharded_matches_single_chip(self, tmp_path):
        from f9tpu.parallel import make_mesh
        from f9tpu.ops.chain import Chain, ConvolutionReverb

        src, ir = TestStreamReverbTail._hit_with_reverb(
            TestStreamReverbTail(), tmp_path)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=9, remove_dc=False,
                               reverb_mode=True, noise_floor_db=-85.0,
                               chain=Chain(ConvolutionReverb(ir, wet=0.6,
                                                             dry=0.4)))
        o1 = str(tmp_path / "single.wav")
        n1 = stream_resample_file(src, o1, cfg, chunk_seconds=0.25)
        mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
        o2 = str(tmp_path / "sharded.wav")
        n2 = stream_resample_file(src, o2, cfg, chunk_seconds=0.25, mesh=mesh)
        # round 4: with the reverb's UPOLS state on the absolute block grid,
        # chunk size no longer shifts any rounding — the sharded run (4x
        # super-chunks) is BITWISE the single-chip run, tail length included
        hop = 48000 * cfg.tail_hop_ms // 1000
        assert n1 > 48000 and n1 == n2, (n1, n2)
        assert open(o1, "rb").read() == open(o2, "rb").read()
        y2, _ = read_wav(o2)
        assert 20 * np.log10(np.abs(y2[:, -hop:]).max() + 1e-30) < -85.0


class TestStreamVarispeedRows:
    """Varispeed streams ride the host-marshalled cycle-rows form
    — the streaming twin of the batch
    scheduler's rows dispatch.  The rows and flat forms share
    `_banded_eval_rows`, so these are BYTE-identity contracts."""

    def test_stream_step_rows_form_bitwise_equals_flat(self):
        import jax.numpy as jnp

        from f9tpu.models.filters import design_cycle_bank
        from f9tpu.ops.resample import _banded_plan
        from f9tpu.pipeline.stream import _stream_step

        rate_in, rate_out = 44100, 44056
        bank = design_cycle_bank(rate_in, rate_out, quality="low")
        M = bank.M
        cycles = 3
        chunk_in = cycles * M
        w_rows = _banded_plan(bank)[3]
        need = (cycles + -(-w_rows // M) - 1) * M
        rng = np.random.default_rng(3)
        span = (0.4 * rng.standard_normal((2, need))).astype(np.float32)
        rows = np.ascontiguousarray(
            np.lib.stride_tricks.sliding_window_view(span, w_rows, axis=-1)
            [:, ::M, :][:, :cycles])
        seeds = jnp.zeros((2,), jnp.uint32)
        kw = dict(cycles=cycles, rate_in=rate_in, rate_out=rate_out,
                  quality="low", kind="sinc", bits=24, do_dither=True)
        a, _ = _stream_step(jnp.asarray(span), jnp.zeros((2, 0)), seeds,
                            jnp.int32(0), jnp.float32(1.0), **kw)
        b, _ = _stream_step(jnp.asarray(rows), jnp.zeros((2, 0)), seeds,
                            jnp.int32(0), jnp.float32(1.0), rows_form=True,
                            **kw)
        assert np.array_equal(np.asarray(a), np.asarray(b))
        del chunk_in

    def test_varispeed_stream_chunk_size_invariant(self, tmp_path):
        rate = 44100
        rng = np.random.default_rng(12)
        x = (0.4 * rng.standard_normal((2, 3 * rate + 1231))).astype(
            np.float32)
        src = str(tmp_path / "ntsc.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=44056,
                               quality="low", seed=4, remove_dc=False)
        o1 = str(tmp_path / "s1.wav")
        o2 = str(tmp_path / "s2.wav")
        # NTSC bank: M=11025 input frames per cycle, so chunk plans of 1-3
        # cycles exercise marshalling across different chunk boundaries
        stream_resample_file(src, o1, cfg, chunk_seconds=0.3)
        stream_resample_file(src, o2, cfg, chunk_seconds=0.8)
        assert open(o1, "rb").read() == open(o2, "rb").read()

    def test_varispeed_stream_matches_batch(self, tmp_path):
        rate = 44100
        rng = np.random.default_rng(13)
        x = (0.4 * rng.standard_normal((2, 2 * rate + 997))).astype(
            np.float32)
        src = str(tmp_path / "pullup.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path / "out"),
                               target_rate=44056, quality="low", seed=4,
                               remove_dc=False)
        assert BatchProcessor(cfg).run([src]).completed == 1
        sp = str(tmp_path / "streamed.wav")
        n = stream_resample_file(src, sp, cfg, chunk_seconds=0.5)
        yb, _ = read_wav(str(tmp_path / "out" / "pullup_processed.wav"))
        ys, _ = read_wav(sp)
        assert yb.shape == ys.shape and n == ys.shape[1]
        _assert_dither_contract(yb, ys)

    def test_varispeed_sharded_stream_bitwise_matches_single_chip(
            self, tmp_path):
        from f9tpu.parallel import make_mesh

        rate = 44100
        rng = np.random.default_rng(14)
        # 4 frames-shards x 0.3 s chunks -> super-chunks of 1 cycle each at
        # NTSC M=11025; several super-chunks cover the file
        x = (0.4 * rng.standard_normal((2, 3 * rate + 421))).astype(
            np.float32)
        src = str(tmp_path / "ntsc_big.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=44056,
                               quality="low", seed=6, remove_dc=True)
        o1 = str(tmp_path / "single.wav")
        n1 = stream_resample_file(src, o1, cfg, chunk_seconds=0.3)
        mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
        o2 = str(tmp_path / "sharded.wav")
        n2 = stream_resample_file(src, o2, cfg, chunk_seconds=0.3, mesh=mesh)
        assert n1 == n2
        # rows marshalling is shared, so the sharded banded path is BITWISE
        # the single-chip stream (no conv-shape caveat like the dense path)
        assert open(o1, "rb").read() == open(o2, "rb").read()


class TestChainRingAutoGrow:
    def test_chain_ring_exceeding_chunk_autogrows(self, tmp_path):
        """A chain whose ring-out exceeds one streaming chunk must GROW the
        chunk (output is chunk-size invariant) instead of raising — the
        scheduler routes any oversized chain config to this path, so a
        hard failure here would regress files round 2 processed fine."""
        from f9tpu.ops.chain import Chain, Delay

        rate = 44100
        rng = np.random.default_rng(21)
        x = (0.3 * rng.standard_normal((2, rate))).astype(np.float32)
        src = str(tmp_path / "ring.wav")
        write_wav(src, x, rate, bits=24)
        # 0.35 s delay ring (16800 out frames) >> one 0.1 s chunk (~4800)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=3,
                               chain=Chain(Delay(0.35)), latency_frames=0)
        small = str(tmp_path / "small_chunk.wav")
        n1 = stream_resample_file(src, small, cfg, chunk_seconds=0.1)
        big = str(tmp_path / "big_chunk.wav")
        n2 = stream_resample_file(src, big, cfg, chunk_seconds=1.0)
        assert n1 == n2 == 48000
        # round 4: per-stage state rings make this byte-exact too (a Delay's
        # ring is its whole state; the grown chunk only changes batching)
        assert open(small, "rb").read() == open(big, "rb").read()


class TestStreamLifecycle:
    def test_sharded_stream_chain_ring_autogrows_too(self, tmp_path):
        """The chunk auto-grow is hoisted above the mesh branch: a chain
        ring bigger than the requested chunk streams on the frames-sharded
        path as well (it used to raise only there)."""
        from f9tpu.ops.chain import Chain, Delay
        from f9tpu.parallel import make_mesh

        rate = 44100
        rng = np.random.default_rng(31)
        x = (0.3 * rng.standard_normal((2, rate))).astype(np.float32)
        src = str(tmp_path / "ringsh.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=3,
                               chain=Chain(Delay(0.35)), latency_frames=0)
        mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
        o1 = str(tmp_path / "sh.wav")
        n1 = stream_resample_file(src, o1, cfg, chunk_seconds=0.05, mesh=mesh)
        o2 = str(tmp_path / "sc.wav")
        n2 = stream_resample_file(src, o2, cfg, chunk_seconds=1.0)
        assert n1 == n2 == 48000
        ys, _ = read_wav(o1)
        yb, _ = read_wav(o2)
        _assert_dither_contract(ys, yb)

    def test_failed_stream_removes_part_file(self, tmp_path, monkeypatch):
        """A mid-stream failure must not leave a .part corpse beside the
        deliverables (the wrapper owns the temp lifecycle)."""
        import f9tpu.pipeline.stream as stream_mod

        src = str(tmp_path / "die.wav")
        write_wav(src, np.zeros((1, 30000), np.float32), 44100, bits=24)

        real = stream_mod._stream_step

        def boom(*a, **k):
            raise RuntimeError("injected device failure")

        monkeypatch.setattr(stream_mod, "_stream_step", boom)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=1)
        out = str(tmp_path / "o.wav")
        with pytest.raises(RuntimeError):
            stream_resample_file(src, out, cfg, chunk_seconds=0.1)
        assert not os.path.exists(out)
        assert not os.path.exists(out + ".part")
        monkeypatch.setattr(stream_mod, "_stream_step", real)
        assert stream_resample_file(src, out, cfg, chunk_seconds=0.1) > 0


class TestDownloadWire:
    """Round-3e D2H wire formats: the stream downloads device-packed 24-bit
    bytes (or int16 at 16 bits) instead of int32 codes — the bytes on disk
    must be identical to the int32-wire form, and the incremental writers'
    `append_payload` must be byte-equal to `append_codes` of the same
    codes."""

    def test_wav_append_payload_equals_append_codes(self, tmp_path):
        import jax.numpy as jnp

        from f9tpu.io.wav import WavWriter
        from f9tpu.ops.devcodec import pack24_interleaved

        rng = np.random.default_rng(0)
        codes = rng.integers(-(1 << 23), 1 << 23,
                             size=(2, 777)).astype(np.int32)
        a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
        with WavWriter(a, 2, 48000, bits=24) as w:
            w.append_codes(codes[:, :500])
            w.append_codes(codes[:, 500:])
        payload = np.asarray(pack24_interleaved(jnp.asarray(codes)))
        with WavWriter(b, 2, 48000, bits=24) as w:
            w.append_payload(payload[: 500 * 6])
            w.append_payload(payload[500 * 6 :])
        assert open(a, "rb").read() == open(b, "rb").read()

    def test_aiff_append_payload_equals_append_codes(self, tmp_path):
        import jax.numpy as jnp

        from f9tpu.io.aiff import AiffWriter
        from f9tpu.ops.devcodec import pack24_interleaved

        rng = np.random.default_rng(1)
        codes = rng.integers(-(1 << 23), 1 << 23,
                             size=(3, 321)).astype(np.int32)
        a, b = str(tmp_path / "a.aiff"), str(tmp_path / "b.aiff")
        with AiffWriter(a, 3, 44100, bits=24) as w:
            w.append_codes(codes)
        payload = np.asarray(pack24_interleaved(jnp.asarray(codes)))
        with AiffWriter(b, 3, 44100, bits=24) as w:
            w.append_payload(payload)
        assert open(a, "rb").read() == open(b, "rb").read()

    def test_append_payload_validates(self, tmp_path):
        from f9tpu.io.wav import WavWriter

        with WavWriter(str(tmp_path / "v.wav"), 2, 48000, bits=24) as w:
            with pytest.raises(ValueError, match="whole number of frames"):
                w.append_payload(np.zeros(7, np.uint8))
            w.append_payload(np.zeros(12, np.uint8))
        with WavWriter(str(tmp_path / "v16.wav"), 2, 48000, bits=16) as w:
            with pytest.raises(ValueError, match="24-bit"):
                w.append_payload(np.zeros(12, np.uint8))
            w.append_codes(np.zeros((2, 3), np.int16))   # i16 wire widens

    def test_stream_to_aiff_output_matches_wav_output(self, tmp_path):
        """The AIFF writer's host byte-swap of the device-packed payload
        decodes to the same samples as the WAV output."""
        rate = 44100
        rng = np.random.default_rng(2)
        x = (0.3 * rng.standard_normal((2, rate // 2 + 111))).astype(np.float32)
        src = str(tmp_path / "s.wav")
        write_wav(src, x, rate, bits=24)
        cfg_w = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                                 quality="low", seed=9, remove_dc=False)
        cfg_a = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                                 quality="low", seed=9, remove_dc=False,
                                 output_format="aiff")
        ow, oa = str(tmp_path / "o.wav"), str(tmp_path / "o.aiff")
        stream_resample_file(src, ow, cfg_w, chunk_seconds=0.2)
        stream_resample_file(src, oa, cfg_a, chunk_seconds=0.2)
        yw, _ = read_wav(ow)
        ya, _ = read_aiff(oa)
        np.testing.assert_array_equal(yw, ya)

    def test_stream_32bit_keeps_int32_wire(self, tmp_path):
        rate = 44100
        rng = np.random.default_rng(3)
        x = (0.3 * rng.standard_normal((2, rate // 3))).astype(np.float32)
        src = str(tmp_path / "s32.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=4, bits=32,
                               remove_dc=False)
        out = str(tmp_path / "o32.wav")
        n = stream_resample_file(src, out, cfg, chunk_seconds=0.15)
        from f9tpu.io import probe
        info = probe(out)
        assert info.bit_depth == 32 and info.num_frames == n


class TestRawUploadWire:
    """Round-3e raw H2D upload: integer-PCM sources ship container bytes and
    decode/fan-out/route/DC-subtract on device.  The integer->float scaling
    is a power of two and the op order replicates the host `routed()` +
    pre-pass, so the output must be BITWISE identical to the float wire."""

    def _both(self, monkeypatch, src, cfg, tmp_path, chunk_seconds=0.23):
        import f9tpu.pipeline.stream as sm
        from f9tpu.io.aiff import AiffReader
        from f9tpu.io.wav import WavReader

        o_raw = str(tmp_path / "o_raw.out")
        o_flt = str(tmp_path / "o_flt.out")
        n1 = stream_resample_file(src, o_raw, cfg,
                                  chunk_seconds=chunk_seconds)
        monkeypatch.setattr(WavReader, "raw_wire", lambda self: None)
        monkeypatch.setattr(AiffReader, "raw_wire", lambda self: None)
        n2 = stream_resample_file(src, o_flt, cfg,
                                  chunk_seconds=chunk_seconds)
        assert n1 == n2
        assert open(o_raw, "rb").read() == open(o_flt, "rb").read()
        return n1

    def test_wav24_routing_dc_latency_bitwise(self, tmp_path, monkeypatch):
        rate = 44100
        rng = np.random.default_rng(11)
        x = (0.3 * rng.standard_normal((3, rate // 2 + 73))
             + 0.01).astype(np.float32)              # DC offset: mean path on
        src = str(tmp_path / "s24.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=2, remove_dc=True,
                               channel_routing=[2, -1, 0],
                               trim_enabled=True, latency_frames=37)
        self._both(monkeypatch, src, cfg, tmp_path)

    def test_wav16_mono_fanout_bitwise(self, tmp_path, monkeypatch):
        rate = 48000
        rng = np.random.default_rng(12)
        x = (0.4 * rng.standard_normal((1, rate // 3))).astype(np.float32)
        src = str(tmp_path / "s16.wav")
        write_wav(src, x, rate, bits=16)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=44100,
                               quality="low", seed=5, remove_dc=False,
                               output_channels=2, bits=16)
        self._both(monkeypatch, src, cfg, tmp_path)

    def test_aiff24_big_endian_bitwise(self, tmp_path, monkeypatch):
        rate = 44100
        rng = np.random.default_rng(13)
        x = (0.3 * rng.standard_normal((2, rate // 4 + 17))).astype(np.float32)
        src = str(tmp_path / "s.aiff")
        write_aiff(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=6, remove_dc=True)
        self._both(monkeypatch, src, cfg, tmp_path)

    def test_reverb_detector_bitwise(self, tmp_path, monkeypatch):
        rate = 44100
        rng = np.random.default_rng(14)
        n = rate // 2
        x = (0.5 * rng.standard_normal((2, n))).astype(np.float32)
        x[:, n // 3 :] *= np.float32(1e-6)           # quiet tail to detect
        src = str(tmp_path / "rv.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=7, remove_dc=False,
                               reverb_mode=True, noise_floor_db=-90.0)
        self._both(monkeypatch, src, cfg, tmp_path, chunk_seconds=0.11)

    def test_sharded_raw_wire_bitwise(self, tmp_path, monkeypatch):
        """Round 4 (VERDICT r3 #3): the raw upload wire on the
        frames-SHARDED stream — routing + silent channel + DC + latency
        trim — must emit bytes identical to (a) the single-chip stream at
        the matching chunk plan and (b) the float wire on the same mesh."""
        from f9tpu.io.wav import WavReader
        from f9tpu.parallel import make_mesh

        rate = 44100
        rng = np.random.default_rng(16)
        x = (0.3 * rng.standard_normal((3, int(1.2 * rate)))
             + 0.01).astype(np.float32)              # DC offset: mean path on
        src = str(tmp_path / "sh24.wav")
        write_wav(src, x, rate, bits=24)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=2, remove_dc=True,
                               channel_routing=[2, -1, 0],
                               trim_enabled=True, latency_frames=37)
        # single chip first (raw wire), chunk 0.4 s == 4-shard super-chunk
        o_single = str(tmp_path / "sh_single.wav")
        n0 = stream_resample_file(src, o_single, cfg, chunk_seconds=0.4)
        mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
        o_raw = str(tmp_path / "sh_raw.wav")
        n1 = stream_resample_file(src, o_raw, cfg, chunk_seconds=0.1,
                                  mesh=mesh)
        monkeypatch.setattr(WavReader, "raw_wire", lambda self: None)
        o_flt = str(tmp_path / "sh_flt.wav")
        n2 = stream_resample_file(src, o_flt, cfg, chunk_seconds=0.1,
                                  mesh=mesh)
        assert n0 == n1 == n2
        raw_bytes = open(o_raw, "rb").read()
        assert raw_bytes == open(o_flt, "rb").read()
        assert raw_bytes == open(o_single, "rb").read()

    def test_sharded_raw_wire_16bit_fanout_bitwise(self, tmp_path,
                                                   monkeypatch):
        """16-bit source + mono fan-out + 16-bit output on the sharded
        stream: raw wire (int16 payload both directions) equals the float
        wire byte-for-byte."""
        from f9tpu.io.wav import WavReader
        from f9tpu.parallel import make_mesh

        rate = 48000
        rng = np.random.default_rng(17)
        x = (0.4 * rng.standard_normal((1, rate))).astype(np.float32)
        src = str(tmp_path / "sh16.wav")
        write_wav(src, x, rate, bits=16)
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=44100,
                               quality="low", seed=5, remove_dc=False,
                               output_channels=2, bits=16)
        mesh = make_mesh(num_files_shards=2, num_frames_shards=4)
        o_raw = str(tmp_path / "sh16_raw.wav")
        n1 = stream_resample_file(src, o_raw, cfg, chunk_seconds=0.11,
                                  mesh=mesh)
        monkeypatch.setattr(WavReader, "raw_wire", lambda self: None)
        o_flt = str(tmp_path / "sh16_flt.wav")
        n2 = stream_resample_file(src, o_flt, cfg, chunk_seconds=0.11,
                                  mesh=mesh)
        assert n1 == n2
        assert open(o_raw, "rb").read() == open(o_flt, "rb").read()

    def test_float_wav_keeps_float_wire(self, tmp_path):
        """IEEE-float sources have no raw wire; the stream must still work."""
        rate = 44100
        rng = np.random.default_rng(15)
        x = (0.3 * rng.standard_normal((2, rate // 4))).astype(np.float32)
        src = str(tmp_path / "f32.wav")
        write_wav(src, x, rate, bits=32)             # IEEE float container
        from f9tpu.io.wav import WavReader
        with WavReader(src) as r:
            assert r.raw_wire() is None
        cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                               quality="low", seed=8)
        out = str(tmp_path / "of.wav")
        assert stream_resample_file(src, out, cfg, chunk_seconds=0.2) > 0


def test_stream_16bit_aiff_matches_wav(tmp_path):
    """The i16 D2H wire through the big-endian AIFF writer decodes to the
    same samples as the 16-bit WAV output (value-exact narrowing)."""
    rate = 44100
    rng = np.random.default_rng(21)
    x = (0.4 * rng.standard_normal((2, rate // 3 + 77))).astype(np.float32)
    src = str(tmp_path / "s.wav")
    write_wav(src, x, rate, bits=24)
    kw = dict(output_dir=str(tmp_path), target_rate=48000, quality="low",
              seed=11, bits=16, remove_dc=False)
    ow, oa = str(tmp_path / "o.wav"), str(tmp_path / "o.aiff")
    stream_resample_file(src, ow, ProcessingConfig(**kw), chunk_seconds=0.2)
    stream_resample_file(src, oa,
                         ProcessingConfig(**kw, output_format="aiff"),
                         chunk_seconds=0.2)
    yw, _ = read_wav(ow)
    ya, _ = read_aiff(oa)
    np.testing.assert_array_equal(yw, ya)
