"""Ogg Vorbis decoder tests.

Three layers, mirroring the FLAC test strategy (tests/test_flac.py):

1. conformance vectors — libvorbisenc-encoded streams (tests/vorbis_ref.py)
   decoded by the product decoder and cross-checked against libvorbisfile,
   the independent oracle (skipped if the system libraries are absent);
2. spec-only paths libvorbisenc never emits — floor type 0, residue
   type 0, single-entry codebooks — exercised by a HAND-ASSEMBLED stream
   (LSB-first bit writer + Ogg page writer below) and checked against
   direct spec math computed independently in the test;
3. container robustness — CRC corruption, truncation, chained/multiplexed
   streams, packet spanning — and the io/codec dispatch surface.
"""

import os
import struct

import numpy as np
import pytest

import vorbis_ref
from f9tpu.io import codec
from f9tpu.io.ogg import OggError, ogg_crc, packets_from_pages, read_pages
from f9tpu.io.vorbis import (OggVorbisReader, VorbisError, _Bits, _Codebook,
                             decode_vorbis, probe_vorbis_bytes, read_ogg)

needs_libvorbis = pytest.mark.skipif(
    not vorbis_ref.available(), reason="system libvorbis not present")


def _encode(x, rate, q=0.4):
    return vorbis_ref.encode_ogg(np.asarray(x, np.float32), rate, q)


def _tones(ch, n, rate, seed=0):
    t = np.arange(n) / rate
    return np.stack([0.4 * np.sin(2 * np.pi * (300 + 130 * c) * t)
                     for c in range(ch)]).astype(np.float32)


def _transient(ch, n, seed=1):
    rng = np.random.default_rng(seed)
    x = 0.02 * rng.standard_normal((ch, n))
    for k in range(40, n, 4000):
        x[:, k:k + 60] += 0.7 * rng.standard_normal((ch, 60))
    return x.astype(np.float32)


def _cross_check(tmp_path, x, rate, q, tol_db=-100.0):
    data = _encode(x, rate, q)
    p = str(tmp_path / "v.ogg")
    with open(p, "wb") as f:
        f.write(data)
    y, r, info = decode_vorbis(data)
    ref, rr = vorbis_ref.decode_ogg_ref(p)
    assert (r, y.shape) == (rr, ref.shape)
    d = y.astype(np.float64) - ref.astype(np.float64)
    rms_ref = max(np.sqrt((ref.astype(np.float64) ** 2).mean()), 1e-12)
    db = 20 * np.log10(max(np.sqrt((d ** 2).mean()), 1e-15) / rms_ref)
    assert db <= tol_db, db
    # probe agrees with the full decode without decoding
    pi, pn = probe_vorbis_bytes(data)
    assert (pi.channels, pi.sample_rate, pn) == (ref.shape[0], rr,
                                                 ref.shape[1])
    return data, y


# --------------------------------------------------------- conformance


@needs_libvorbis
@pytest.mark.parametrize("ch,n,rate,q", [
    (2, 44100, 44100, 0.4),     # single-page eos stream (end-trim rule)
    (2, 70000, 44100, 0.5),     # transients: long/short block switching
    (1, 12345, 8000, -0.1),     # lowest quality, low rate, odd length
    (6, 24000, 48000, 0.4),     # 5.1: multiple coupling steps
    (2, 700, 44100, 1.0),       # tiny stream, highest quality
    (1, 64, 44100, 0.4),        # shorter than one block
])
def test_cross_check_matrix(tmp_path, ch, n, rate, q):
    x = _transient(ch, n) if n > 2000 else _tones(ch, n, rate)
    _cross_check(tmp_path, x, rate, q)


@needs_libvorbis
def test_decoded_lengths_sample_exact(tmp_path):
    for n in (64, 576, 1024, 1025, 44100, 44101):
        x = _tones(1, n, 44100)
        data = _encode(x, 44100, 0.3)
        y, r, _ = decode_vorbis(data)
        assert y.shape == (1, n)


@needs_libvorbis
def test_comment_header_tags_kept(tmp_path):
    data = _encode(_tones(1, 2000, 44100), 44100, 0.4)
    _, _, info = decode_vorbis(data)
    assert any(c.startswith("ENCODER=") for c in info.comments)
    assert "libVorbis" in info.vendor


# --------------------------------------------------------- reader


@needs_libvorbis
def test_reader_chunked_equals_whole(tmp_path):
    x = _transient(2, 60000)
    data = _encode(x, 44100, 0.4)
    p = str(tmp_path / "r.ogg")
    with open(p, "wb") as f:
        f.write(data)
    whole, rate = read_ogg(p)
    with OggVorbisReader(p) as r:
        assert (r.num_channels, r.sample_rate) == (2, 44100)
        assert r.num_frames == whole.shape[1]
        pos, outs = 0, []
        for sz in (997, 1, 4096, 64, 1 << 20):
            c = r.read(pos, sz)
            outs.append(c)
            pos += c.shape[1]
        got = np.concatenate(outs, axis=1)
        assert np.array_equal(got, whole)


@needs_libvorbis
def test_reader_random_access_bitwise(tmp_path):
    x = _transient(2, 50000)
    p = str(tmp_path / "ra.ogg")
    with open(p, "wb") as f:
        f.write(_encode(x, 44100, 0.3))
    whole, _ = read_ogg(p)
    rng = np.random.default_rng(5)
    with OggVorbisReader(p) as r:
        for _ in range(60):
            start = int(rng.integers(0, whole.shape[1]))
            cnt = int(rng.integers(1, 8000))
            got = r.read(start, cnt)
            exp = whole[:, start:start + cnt]
            assert np.array_equal(got, exp), (start, cnt)
        # past-the-end and empty reads
        assert r.read(whole.shape[1], 100).shape == (2, 0)
        assert r.read(5, 0).shape == (2, 0)


# --------------------------------------------------------- codec dispatch


@needs_libvorbis
def test_codec_dispatch_ogg(tmp_path):
    x = _tones(2, 30000, 44100)
    p = str(tmp_path / "in.ogg")
    with open(p, "wb") as f:
        f.write(_encode(x, 44100, 0.4))
    info = codec.probe(p)
    assert (info.container, info.is_float, info.bit_depth) == ("ogg", True,
                                                               32)
    assert (info.sample_rate, info.num_channels) == (44100, 2)
    y, r = codec.read_audio(p)
    assert (r, y.shape[0], y.shape[1]) == (44100, 2, info.num_frames)
    with codec.open_reader(p) as rd:
        c = rd.read(100, 200)
        assert np.array_equal(c, y[:, 100:300])
    with pytest.raises(ValueError, match="raw integer"):
        codec.read_raw_pcm(p)
    assert codec.is_supported(p)


def test_codec_still_rejects_unknown_extensions(tmp_path):
    p = str(tmp_path / "x.aac")
    with open(p, "wb") as f:
        f.write(b"\xff\xf1")
    with pytest.raises(ValueError, match="AAC"):
        codec.read_audio(p)
    assert not codec.is_supported(p)


# --------------------------------------------------------- container edges


def test_ogg_crc_known_vector():
    # independent spec check: CRC of a crafted page must match the value
    # a conformant muxer would write (cross-validated against libogg by
    # every passing conformance vector above; this pins the polynomial)
    assert ogg_crc(b"") == 0
    assert ogg_crc(b"\x01") == 0x04C11DB7


@needs_libvorbis
def test_corrupt_page_crc_raises(tmp_path):
    data = bytearray(_encode(_tones(1, 5000, 44100), 44100, 0.4))
    # flip one byte in the LAST page's body (headers parse fine)
    data[-3] ^= 0x40
    with pytest.raises(OggError, match="CRC"):
        list(read_pages(bytes(data)))


@needs_libvorbis
def test_chained_stream_rejected(tmp_path):
    one = _encode(_tones(1, 3000, 44100), 44100, 0.4)
    with pytest.raises(VorbisError, match="chained"):
        decode_vorbis(one + one)


@needs_libvorbis
def test_truncated_stream_raises(tmp_path):
    data = _encode(_tones(1, 3000, 44100), 44100, 0.4)
    with pytest.raises(OggError):
        list(read_pages(data[:len(data) // 2 + 3]))


@needs_libvorbis
def test_multiplexed_picks_vorbis_stream(tmp_path):
    """A grouped (multiplexed) physical stream: a non-Vorbis logical
    stream interleaved page-by-page must be skipped, not decoded."""
    vorb = _encode(_tones(1, 4000, 44100), 44100, 0.4)
    pages = list(read_pages(vorb))
    # synthesize a one-page foreign stream (serial differs; bos+eos)
    body = b"\x7fFOREIGN-STREAM-DATA"
    seg = bytes([len(body)])
    hdr = (b"OggS" + b"\x00" + bytes([0x06])
           + struct.pack("<qIII", 0, 0xDEADBEEF, 0, 0)
           + b"\x01" + seg)
    crc = ogg_crc(hdr + body)
    hdr = hdr[:22] + struct.pack("<I", crc) + hdr[26:]
    foreign = hdr + body
    # splice the foreign page after the first Vorbis page
    first_end = pages[1].offset
    mux = vorb[:first_end] + foreign + vorb[first_end:]
    y, r, _ = decode_vorbis(mux)
    ref, _, _ = decode_vorbis(vorb)
    assert np.array_equal(y, ref)


@needs_libvorbis
def test_packet_spanning_pages(tmp_path):
    """High-quality noise forces packets > 255 lacing bytes and page
    spans; packet reassembly must be exact (checked implicitly by the
    cross-check, explicitly here via lacing structure)."""
    rng = np.random.default_rng(9)
    x = (0.4 * rng.standard_normal((2, 30000))).astype(np.float32)
    data = _encode(x, 44100, 1.0)
    spans = [lv for pg in read_pages(data) for lv in pg.lacing]
    assert 255 in spans, "vector does not exercise lacing continuation"
    _cross_check(tmp_path, x, 44100, 1.0)


def test_not_ogg_raises(tmp_path):
    with pytest.raises(OggError, match="capture pattern"):
        list(read_pages(b"RIFFxxxxWAVE" + b"\x00" * 64))
    with pytest.raises(VorbisError, match="no Vorbis"):
        decode_vorbis(_ogg_page(b"\x7fnotvorbis", serial=5, seq=0,
                                granule=0, bos=True, eos=True))


# --------------------------------------------------------- hand-built
# streams: the spec paths libvorbisenc never emits


class _BitWriter:
    """LSB-first packer (the Vorbis convention, spec section 2)."""

    def __init__(self):
        self.bits = []

    def w(self, value, nbits):
        for i in range(nbits):
            self.bits.append((value >> i) & 1)

    def whuff(self, code, nbits):
        """Huffman codewords are read MSB-first (root first)."""
        for i in range(nbits - 1, -1, -1):
            self.bits.append((code >> i) & 1)

    def bytes(self):
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out)


def _float32_pack(v):
    """Inverse of spec 9.2.2 float32_unpack, for hand-built codebooks."""
    if v == 0:
        return 0
    sign = 0x80000000 if v < 0 else 0
    v = abs(v)
    exp = 0
    while v != int(v) or (int(v) & 1) == 0 and int(v) > 0 and v > (1 << 20):
        break
    # normalize: mantissa in [2^20, 2^21)
    m = v
    e = 788
    while m < (1 << 20):
        m *= 2
        e -= 1
    while m >= (1 << 21):
        m /= 2
        e += 1
    m = int(round(m))
    del exp, sign
    s = 0x80000000 if np.signbit(np.float64(v)) else 0
    return (0x80000000 if False else 0) | s | (e << 21) | m


def _pack_simple(v):
    """float32_pack for values exactly representable with small mantissa."""
    sign = 0x80000000 if v < 0 else 0
    v = abs(v)
    m, e = v, 788
    while m and m != int(m):
        m *= 2
        e -= 1
    m = int(m)
    while m >= (1 << 21):
        assert m % 2 == 0
        m //= 2
        e += 1
    return sign | (e << 21) | m


def _ogg_page(body, serial, seq, granule, bos=False, eos=False,
              lacing=None):
    if lacing is None:
        lacing = []
        rem = len(body)
        while True:
            lacing.append(min(rem, 255))
            rem -= lacing[-1]
            if lacing[-1] < 255:
                break
    htype = (0x02 if bos else 0) | (0x04 if eos else 0)
    hdr = (b"OggS\x00" + bytes([htype])
           + struct.pack("<qIII", granule, serial, seq, 0)
           + bytes([len(lacing)]) + bytes(lacing))
    crc = ogg_crc(hdr + body)
    hdr = hdr[:22] + struct.pack("<I", crc) + hdr[26:]
    return hdr + body


def _write_codebook(w, dim, lengths, lookup=0, minimum=0.0, delta=0.0,
                    value_bits=1, sequence=0, mults=()):
    w.w(0x564342, 24)
    w.w(dim, 16)
    w.w(len(lengths), 24)
    w.w(0, 1)                          # not ordered
    w.w(0, 1)                          # not sparse
    for ln in lengths:
        w.w(ln - 1, 5)
    w.w(lookup, 4)
    if lookup:
        w.w(_pack_simple(minimum), 32)
        w.w(_pack_simple(delta), 32)
        w.w(value_bits - 1, 4)
        w.w(sequence, 1)
        for m in mults:
            w.w(m, value_bits)


def _build_floor0_stream():
    """Minimal mono stream: one floor0, one residue TYPE 0, one
    single-entry codebook, bs0=bs1=256, two audio packets (primer + one
    emitting 128 samples).  Everything libvorbisenc cannot emit."""
    rate, bs_exp = 8000, 8               # blocksize 256
    # --- identification ---
    w = _BitWriter()
    w.w(0, 32)
    w.w(1, 8)                            # channels
    w.w(rate, 32)
    w.w(0, 32)
    w.w(0, 32)
    w.w(0, 32)
    w.w(bs_exp, 4)
    w.w(bs_exp, 4)
    w.w(1, 1)
    ident = b"\x01vorbis" + w.bytes()
    # --- comment ---
    w = _BitWriter()
    vendor = b"f9tpu-test"
    w.w(len(vendor), 32)
    for b in vendor:
        w.w(b, 8)
    w.w(0, 32)
    w.w(1, 1)
    comment = b"\x03vorbis" + w.bytes()
    # --- setup ---
    w = _BitWriter()
    w.w(3 - 1, 8)                        # three codebooks
    # book 0: residue classbook — dim 2, entries 4, lengths 2 (scalar)
    _write_codebook(w, 2, [2, 2, 2, 2])
    # book 1: residue VQ — dim 2, entries 4, lookup 1 over {-1, +1}
    # (lookup_values = 2, mults {0,1} -> 0*2-1=-1, 1*2-1=+1)
    _write_codebook(w, 2, [2, 2, 2, 2], lookup=1, minimum=-1.0, delta=2.0,
                    value_bits=1, mults=(0, 1))
    # book 2: floor0 LSP — SINGLE-ENTRY book (dim 4, one entry, len 3),
    # lookup 1, sequence flag set: components accumulate to the DISTINCT
    # ascending LSP values 0.25, 0.5, 0.75, 1.0 (coincident LSP roots
    # would legitimately blow the curve up at the shared root)
    _write_codebook(w, 4, [3], lookup=1, minimum=0.25, delta=1.0,
                    value_bits=1, sequence=1, mults=(0,))
    w.w(0, 6)                            # one time transform
    w.w(0, 16)
    w.w(0, 6)                            # one floor
    w.w(0, 16)                           # floor TYPE 0
    w.w(4, 8)                            # order 4
    w.w(rate, 16)
    w.w(64, 16)                          # bark_map_size
    w.w(6, 6)                            # amplitude_bits
    w.w(10, 8)                           # amplitude_offset
    w.w(0, 4)                            # one book
    w.w(2, 8)                            # -> book 2
    w.w(0, 6)                            # one residue
    w.w(0, 16)                           # residue TYPE 0
    w.w(0, 24)                           # begin
    w.w(128, 24)                         # end (n2)
    w.w(4 - 1, 24)                       # partition size 4
    w.w(2 - 1, 6)                        # two classifications
    w.w(0, 8)                            # classbook -> book 0
    for _ in range(2):                   # per class: cascade = pass 0 only
        w.w(1, 3)
        w.w(0, 1)
    for _ in range(2):                   # per class, pass 0: book 1
        w.w(1, 8)
    w.w(0, 6)                            # one mapping, type 0
    w.w(0, 16)
    w.w(0, 1)                            # one submap
    w.w(0, 1)                            # no coupling
    w.w(0, 2)                            # reserved
    w.w(0, 8)                            # time config
    w.w(0, 8)                            # floor 0
    w.w(0, 8)                            # residue 0
    w.w(0, 6)                            # one mode
    w.w(0, 1)                            # blockflag 0
    w.w(0, 16)
    w.w(0, 16)
    w.w(0, 8)                            # mapping 0
    w.w(1, 1)                            # framing
    setup = b"\x05vorbis" + w.bytes()

    def audio_packet():
        w = _BitWriter()
        w.w(0, 1)                        # audio type
        # zero mode bits (single mode)
        w.w(40, 6)                       # floor0 amplitude = 40
        w.w(0, 1)                        # book number (ilog(1) = 1 bit)
        w.whuff(0, 3)                    # single-entry book: 3 junk bits
        # residue pass 0: 32 partitions, classwords/codeword = 2 ->
        # 16 classification codewords, each followed by its partitions
        # class codeword entry 1 = (0*2 + 1): partitions [class0, class1]
        for _ in range(16):
            w.whuff(1, 2)                # classbook entry 1
            # partition A (class 0): step = 4/2 = 2 vector reads
            w.whuff(3, 2)                # VQ entry 3 -> (+1, +1)
            w.whuff(0, 2)                # VQ entry 0 -> (-1, -1)
            # partition B (class 1):
            w.whuff(2, 2)                # VQ entry 2 -> (+1, -1)
            w.whuff(1, 2)                # VQ entry 1 -> (-1, +1)
        return b"" + w.bytes()

    pk = audio_packet()
    pages = (_ogg_page(ident, 99, 0, 0, bos=True)
             + _ogg_page(comment + setup, 99, 1, 0,
                         lacing=[len(comment), len(setup)])
             + _ogg_page(pk + pk, 99, 2, 128, eos=True,
                         lacing=[len(pk), len(pk)]))
    return pages, pk


def _spec_floor0_curve(order, rate, bark_map_size, amplitude,
                       amplitude_bits, amplitude_offset, lsp, n2):
    """Direct per-bin spec math (6.2.2-6.2.3), written independently of
    the product implementation."""
    import math

    def bark(x):
        return (13.1 * math.atan(0.00074 * x)
                + 2.24 * math.atan(1.85e-8 * x * x) + 1e-4 * x)

    out = np.zeros(n2)
    for i in range(n2):
        mp = min(int(bark(rate / (2.0 * n2) * i)
                     * bark_map_size / bark(0.5 * rate)),
                 bark_map_size - 1)
        omega = math.pi * mp / bark_map_size
        cw = math.cos(omega)
        if order % 2:
            p = (1 - cw * cw)
            for j in range((order - 3) // 2 + 1):
                p *= 4 * (math.cos(lsp[2 * j + 1]) - cw) ** 2
            q = 0.25
            for j in range((order - 1) // 2 + 1):
                q *= 4 * (math.cos(lsp[2 * j]) - cw) ** 2
        else:
            p = (1 - cw) / 2
            q = (1 + cw) / 2
            for j in range(order // 2):
                p *= 4 * (math.cos(lsp[2 * j + 1]) - cw) ** 2
                q *= 4 * (math.cos(lsp[2 * j]) - cw) ** 2
        amp_max = (1 << amplitude_bits) - 1
        out[i] = math.exp(0.11512925
                          * (amplitude * amplitude_offset
                             / (amp_max * math.sqrt(p + q))
                             - amplitude_offset))
    return out


def test_handbuilt_floor0_residue0_stream():
    """Floor type 0 + residue type 0 + a single-entry codebook, decoded
    end to end and checked against direct spec math."""
    data, pk = _build_floor0_stream()
    y, r, info = decode_vorbis(data)
    assert r == 8000 and y.shape == (1, 128)
    # expected: residue pattern from the hand-written packet
    res = np.zeros(128, np.float32)
    for part in range(32):
        off = part * 4
        if part % 2 == 0:            # class 0 partitions: entries 3 then 0
            # type 0 interleave, step 2: v0 -> [off, off+2], v1 -> [off+1,
            # off+3]; lookup-1 lattice: entry e -> (m[e%2], m[e//2])
            res[off] += 1            # entry 3 = (+1, +1)
            res[off + 2] += 1
            res[off + 1] += -1       # entry 0 = (-1, -1)
            res[off + 3] += -1
        else:                        # class 1: entries 2 then 1
            res[off] += -1           # entry 2 = (-1, +1)
            res[off + 2] += 1
            res[off + 1] += 1        # entry 1 = (+1, -1)
            res[off + 3] += -1
    curve = _spec_floor0_curve(4, 8000, 64, 40, 6, 10,
                               [0.25, 0.5, 0.75, 1.0], 128)
    spec = res.astype(np.float64) * curve
    # direct IMDCT (textbook double loop) + vorbis window, lapped center
    n = 256
    jj = np.arange(n)
    imdct = np.array([(spec * np.cos(2 * np.pi / n * (j + 0.5 + n / 4)
                                     * (np.arange(128) + 0.5))).sum()
                      for j in jj])
    win = np.sin(0.5 * np.pi
                 * np.sin((jj + 0.5) / n * np.pi) ** 2)
    blk = imdct * win
    expected = blk[128:] + blk[:128]   # prev right half + current left
    assert np.allclose(y[0], expected, atol=1e-4)


def test_handbuilt_eop_mid_residue_zeros_tail():
    """EOP during residue decode is not an error (spec 8.6.2): the
    remaining vector stays zero and the frame still decodes."""
    data, pk = _build_floor0_stream()
    # rebuild final page with the SECOND packet truncated mid-residue
    short = pk[:8]
    pages = data[:data.rindex(b"OggS")]
    final = _ogg_page(pk + short, 99, 2, 128, eos=True,
                      lacing=[len(pk), len(short)])
    y, r, _ = decode_vorbis(pages + final)
    assert y.shape == (1, 128)
    assert np.isfinite(y).all()


def test_handbuilt_reject_bad_framing():
    data, pk = _build_floor0_stream()
    pages = list(read_pages(data))
    pkts = [p for p, _, _ in packets_from_pages(pages, serial=99)]
    # corrupt the setup framing bit region: truncated setup must raise
    from f9tpu.io.vorbis import VorbisStreamDecoder
    with pytest.raises(VorbisError):
        VorbisStreamDecoder(pkts[0], pkts[1], pkts[2][:-2])


# --------------------------------------------------------- codebook units


def _codebook_bits(dim, lengths, lookup=0, **kw):
    w = _BitWriter()
    _write_codebook(w, dim, lengths, lookup=lookup, **kw)
    return _Bits(w.bytes())


def test_codebook_canonical_assignment_roundtrip():
    """Spec 3.2.1 example: lengths [2,4,4,4,4,2,3,3] assign canonical
    codewords; decoding each codeword returns its entry."""
    lengths = [2, 4, 4, 4, 4, 2, 3, 3]
    cb = _Codebook(_codebook_bits(1, lengths))
    expected_codes = [0b00, 0b0100, 0b0101, 0b0110, 0b0111, 0b10,
                      0b110, 0b111]
    for e, (code, ln) in enumerate(zip(expected_codes, lengths)):
        w = _BitWriter()
        w.whuff(code, ln)
        assert cb.decode_scalar(_Bits(w.bytes())) == e


def test_codebook_underspecified_raises():
    with pytest.raises(VorbisError, match="underspecified"):
        _Codebook(_codebook_bits(1, [1, 2]))


def test_codebook_overspecified_raises():
    with pytest.raises(VorbisError, match="overspecified"):
        _Codebook(_codebook_bits(1, [1, 1, 2]))


def test_codebook_single_entry():
    cb = _Codebook(_codebook_bits(1, [5]))
    w = _BitWriter()
    w.w(0b10110, 5)                       # arbitrary bits, fully consumed
    br = _Bits(w.bytes())
    assert cb.decode_scalar(br) == 0
    assert br.pos == 5


def test_bitreader_lsb_first():
    br = _Bits(bytes([0b10110100, 0b01101011]))
    assert br.read(3) == 0b100            # low three bits of byte 0
    # bits 3..9: byte0 bits 3-7 then byte1 bits 0-1, LSB first
    assert br.read(7) == 0b1110110
    assert br.read(6) == 0b011010         # byte1 bits 2-7
    with pytest.raises(Exception):
        br.read(1)


# --------------------------------------------------------- pipeline e2e


@needs_libvorbis
def test_ogg_batch_pipeline_end_to_end(tmp_path):
    from f9tpu.config import ProcessingConfig
    from f9tpu.pipeline.scheduler import BatchProcessor

    x = _tones(2, 20000, 44100)
    src = str(tmp_path / "in.ogg")
    with open(src, "wb") as f:
        f.write(_encode(x, 44100, 0.4))
    cfg = ProcessingConfig(target_rate=48000, quality="low", bits=24,
                           output_dir=str(tmp_path / "out"))
    res = BatchProcessor(cfg).run([src])
    assert (res.completed, res.failed) == (1, 0)
    outs = os.listdir(tmp_path / "out")
    assert len([o for o in outs if o.endswith(".wav")]) == 1
    y, r = codec.read_audio(str(tmp_path / "out" / outs[0]))
    assert r == 48000 and y.shape[0] == 2


@needs_libvorbis
def test_ogg_streaming_pipeline_end_to_end(tmp_path):
    from f9tpu.config import ProcessingConfig
    from f9tpu.pipeline.stream import stream_resample_file

    x = _transient(2, 50000)
    src = str(tmp_path / "s.ogg")
    with open(src, "wb") as f:
        f.write(_encode(x, 44100, 0.4))
    out = str(tmp_path / "s.wav")
    cfg = ProcessingConfig(target_rate=32000, quality="low", bits=24,
                           output_dir=str(tmp_path))
    stream_resample_file(src, out, cfg, chunk_seconds=0.3)
    y, r = codec.read_audio(out)
    assert r == 32000
    from f9tpu.models.filters import resolve_ratio
    L, M = resolve_ratio(44100, 32000)
    with OggVorbisReader(src) as rd:
        assert y.shape == (2, -(-rd.num_frames * L // M))


# ------------------------------------------------- native front-half twin


@needs_libvorbis
def test_native_front_half_bitwise_parity(tmp_path):
    """The C++ packet front half (f9native.cpp) must be BITWISE identical
    to the Python oracle across the signal/quality matrix — the residue
    float32 adds, coupling and floor curves run per element in the same
    order, so the final PCM must match to the bit (the FLAC twin
    contract, applied to Vorbis)."""
    from f9tpu import native
    from f9tpu.io.vorbis import decode_vorbis

    if not native.available():
        pytest.skip(f"native unavailable: {native.build_error()}")
    rng = np.random.default_rng(77)
    for ch, n, q in [(2, 30000, 0.4), (1, 12000, -0.1), (2, 20000, 1.0),
                     (6, 10000, 0.3)]:
        x = (0.3 * rng.standard_normal((ch, n))).astype(np.float32)
        data = _encode(x, 44100, q)
        y_nat, _, _ = decode_vorbis(data)
        saved = native.available
        try:
            native.available = lambda: False
            y_py, _, _ = decode_vorbis(data)
        finally:
            native.available = saved
        assert np.array_equal(y_nat, y_py), (ch, n, q)


@needs_libvorbis
def test_native_decode_speedup(tmp_path):
    """The native path must actually engage (handle built) and carry the
    conformance matrix — sanity-pinned here."""
    from f9tpu import native
    from f9tpu.io.ogg import packets_from_pages, read_pages
    from f9tpu.io.vorbis import VorbisStreamDecoder, _find_vorbis_stream

    if not native.available():
        pytest.skip(f"native unavailable: {native.build_error()}")
    data = _encode(_tones(2, 8000, 44100), 44100, 0.4)
    serial, pages = _find_vorbis_stream(data)
    pk = [p for p, _, _ in packets_from_pages(pages, serial=serial)]
    dec = VorbisStreamDecoder(pk[0], pk[1], pk[2])
    assert dec._nat is not None, "native front half did not engage"
