"""Sharded execution paths: files-axis data parallelism and frames-axis
overlap-save sequence parallelism with ICI halo exchange.

The reference's concurrency is a single RT audio thread against a message
thread (SURVEY.md section 2.4); its multi-device replacements:

- **files axis (DP)**: a batch ``(files, channels, frames)`` sharded over
  chips; the fused graph (`f9tpu.pipeline.graph`) is pure data parallel —
  XLA inserts no collectives beyond the metric all-gathers.

- **frames axis (SP)**: one huge file split across chips as contiguous frame
  chunks.  FIR resampling needs only a local halo (pad_front frames from the
  left neighbour, W-M-pad_front from the right), exchanged with a single
  ``ppermute`` each way per step (SURVEY.md section 5 'long-context':
  overlap-save with halo = taps/2 instead of ring attention).

- **channels axis (TP analog)**: MCFX 8/16-channel buses sharded over chips;
  routing gathers stay local because routing maps are per-bus.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.filters import CycleBank, design_cycle_bank
from ..ops.resample import resample_presliced

__all__ = [
    "process_files_sharded",
    "process_batch_channels_sharded",
    "resample_frames_sharded",
    "required_frames_padding",
    "shard_halos",
]


def process_files_sharded(mesh: Mesh, fn, x, *args):
    """Run ``fn(x, *args)`` with ``x`` (files, channels, frames) sharded over
    the mesh's ``files`` axis; other args replicated.

    Pure data parallelism: files are independent
    (the 'embarrassingly parallel' row of SURVEY.md section 2.4).
    """
    xs = jax.device_put(x, NamedSharding(mesh, P("files", None, None)))
    return _jit_cached(fn)(xs, *args)


@functools.lru_cache(maxsize=64)
def _jit_cached(fn):
    # a fresh jax.jit per call would discard the dispatch cache and
    # re-trace on every batch (the _build_cp_fn lesson); keyed on fn
    # identity, so pass stable module-level callables, not fresh lambdas
    return jax.jit(fn)


def channels_shardable(cfg, num_channels: int, mesh: Mesh) -> tuple[bool, str]:
    """Can this (config, channel-count) batch run channel-sharded on ``mesh``?
    Returns (ok, reason) so the scheduler can log the fallback instead of
    aborting mid-batch."""
    nc = mesh.shape.get("channels", 1)
    if nc <= 1:
        return False, "mesh has no channels axis"
    if num_channels % nc:
        return False, f"{num_channels} channels not divisible by {nc} shards"
    c_local = num_channels // nc
    if cfg.channel_routing is not None:
        import numpy as np

        r = np.asarray(cfg.channel_routing, np.int32)
        if len(r) != num_channels:
            return False, "routing changes the bus width"
        ok = (r < 0) | ((r // c_local) == (np.arange(num_channels) // c_local))
        if not ok.all():
            return False, "routing crosses channel shards"
    if cfg.output_channels not in (None, num_channels):
        return False, "mono fan-out not channel-shardable"
    if cfg.chain is not None:
        for s in getattr(cfg.chain, "stages", ()):
            ir = getattr(s, "ir", None)
            if ir is not None and ir.shape[0] > 1:
                return False, "per-channel IR not channel-shardable"
            if not getattr(s, "channel_local", False):
                # cross-channel stages (linked Compressor, StereoWidth M/S)
                # would see only their shard's channels inside shard_map:
                # the compressor link would silently diverge per shard and
                # width would mis-shape — fall back to files-only sharding.
                # Default FALSE: a user-supplied stage that doesn't know
                # about the flag must not be silently channel-sharded
                # (built-ins opt in with channel_local = True)
                return False, (f"{type(s).__name__} couples channels (or "
                               "does not declare channel_local); "
                               "not channel-shardable")
    return True, ""


def process_batch_channels_sharded(
    x: jax.Array,
    frames_valid,
    cfg,
    rate_in: int,
    seeds,
    mesh: Mesh,
    latency_frames: int = 0,
    noise_floor_db: float | None = None,
):
    """The full fused batch graph with ``(files, channels)`` sharded over the
    mesh's ``files`` x ``channels`` axes — MCFX-style 8/16-channel buses
    spread across chips (Docs/MultiChannel MCFX with JUCE.md:85-163,
    SURVEY.md section 2.4 'channel-axis sharding').

    Per-channel stages (SRC, chain, DC, dither) run shard-local; the per-file
    cross-channel reductions (peak/RMS metrics, the loudest-channel envelope
    that drives reverb-tail detection) ride ``psum``/``pmax`` over the
    ``channels`` axis, so every shard reaches the identical per-file verdict.

    Routing must be *bus-local*: each output channel's source lives on the
    same channel shard (the MCFX contract — routing maps are per-bus).  The
    local gather uses ``axis_index`` so one compiled program serves every
    shard.  Returns a ``ProcessResult`` with int32 codes (flat layout).
    """
    import dataclasses

    from ..pipeline.graph import (
        ProcessResult,
        _cfg_key,
        _default_pad_frames,
    )

    files, C, _T = x.shape
    nf_shards = mesh.shape.get("files", 1)
    if files % nf_shards:
        raise ValueError(f"{files} files not divisible by {nf_shards} file shards")
    ok, reason = channels_shardable(cfg, C, mesh)
    if not ok:
        # checked BEFORE reading mesh.shape["channels"]: a channels-less
        # mesh must surface this graceful reason, not a bare KeyError
        raise ValueError(f"not channel-shardable: {reason}")
    nc = mesh.shape["channels"]
    c_local = C // nc
    r_tuple = (tuple(int(v) for v in cfg.channel_routing)
               if cfg.channel_routing is not None else None)

    lat_static = latency_frames if isinstance(latency_frames, int) else 0
    pad = _default_pad_frames(cfg, rate_in, lat_static)
    # routing/fan-out are handled locally below; strip them from the cfg key
    base_key = _cfg_key(
        dataclasses.replace(cfg, channel_routing=None, output_channels=None),
        pad)
    if noise_floor_db is None:
        noise_floor_db = cfg.noise_floor_db
    nf = jnp.float32(noise_floor_db if noise_floor_db is not None else 1.0)
    static_zero = isinstance(latency_frames, int) and latency_frames == 0
    # always a per-file vector sharded over the files axis: a replicated
    # per-file ARRAY would reach every shard whole and trim_latency's
    # row-repeat pairing would silently mis-assign latencies to
    # (local file, channel) rows — all outputs wrong, no error
    lat = jnp.broadcast_to(jnp.asarray(latency_frames, jnp.int32), (files,))
    valid = jnp.asarray(frames_valid, jnp.int32)
    seeds = jnp.asarray(seeds, jnp.int32)

    fn = _build_cp_fn(mesh, rate_in, cfg.target_rate, base_key, static_zero,
                      cfg.chain, c_local, r_tuple)
    codes, out_frames, term, pk, lvl, nf_est = fn(x, valid, seeds, lat, nf)
    return ProcessResult(codes=codes, out_frames=out_frames,
                         tail_terminated=term, peak_db=pk, rms_db=lvl,
                         noise_floor_db=nf_est)


@functools.lru_cache(maxsize=64)
def _build_cp_fn(mesh, rate_in, rate_out, base_key, static_zero, chain,
                 c_local, r_tuple):
    """Build (once per static signature) the jitted channel-sharded step.
    Caching here matters: a fresh shard_map closure + jax.jit per batch would
    retrace and recompile the whole fused graph on every flush."""
    import numpy as np

    from ..pipeline.graph import _process_impl

    route_map = (jnp.asarray(np.asarray(r_tuple, np.int32))
                 if r_tuple is not None else None)

    def local(xc, v, sd, lat_, nf_):
        silent = None
        if route_map is not None:
            ci = jax.lax.axis_index("channels") * c_local
            rl = jax.lax.dynamic_slice(route_map, (ci,), (c_local,))
            src = jnp.clip(jnp.where(rl < 0, 0, rl) - ci, 0, c_local - 1)
            xc = jnp.take(xc, src, axis=1)
            silent = (rl < 0)[None, :, None]
            xc = jnp.where(silent, 0.0, xc)
        # dither decorrelation across channel shards is handled INSIDE the
        # graph: noise is keyed by the GLOBAL channel id (axis_index *
        # c_local + local index, pipeline/graph.py), so the per-file seed
        # vector must pass through untouched — a per-shard seed perturbation
        # here would desynchronise the bytes from the unsharded run
        codes, out_frames, term, pk, lvl, nf_est = _process_impl(
            xc, v, lat_, nf_, sd,
            rate_in=rate_in, rate_out=rate_out, cfg_key=base_key,
            static_zero_latency=static_zero, chain=chain,
            channel_axis="channels")
        if silent is not None:
            # routed-silent channels stay digital zero even under dither
            codes = jnp.where(silent, 0, codes)
        return codes, out_frames, term, pk, lvl, nf_est

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("files", "channels", None), P("files"), P("files"),
                  P("files"), P()),
        out_specs=(P("files", "channels", None), P("files"), P("files"),
                   P("files"), P("files"), P("files")),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_halos(bank: CycleBank) -> tuple[int, int]:
    """(halo_left, halo_right) in input frames for overlap-save sharding."""
    halo_left = bank.pad_front
    halo_right = max(0, bank.W - bank.M - halo_left)
    return halo_left, halo_right


def required_frames_padding(in_len: int, bank: CycleBank, n_shards: int) -> int:
    """Pad so the input splits into ``n_shards`` equal chunks of whole cycles
    that are each at least one filter halo long (the minimum
    `resample_frames_sharded` accepts)."""
    unit = n_shards * bank.M
    min_chunk_cycles = -(-max(shard_halos(bank)) // bank.M)
    min_len = n_shards * max(1, min_chunk_cycles) * bank.M
    padded = max(min_len, in_len + ((-in_len) % unit))
    return padded - in_len


def resample_frames_sharded(
    x: jax.Array,
    rate_in: int,
    rate_out: int,
    mesh: Mesh,
    quality: str = "high",
    kind: str = "sinc",
    left_halo: jax.Array | None = None,
    right_halo: jax.Array | None = None,
) -> jax.Array:
    """Resample ``x`` (..., frames) with the frames axis sharded over the
    mesh's ``frames`` axis (overlap-save + ppermute halo exchange).

    The frames length must already be a multiple of n_shards * M (use
    `required_frames_padding`).  Output length is frames * L / M (exact).

    ``left_halo``/``right_halo`` (..., halo frames) optionally supply the
    signal *outside* this span — e.g. the file context around a streaming
    super-chunk (`pipeline.stream` multi-chip mode).  Inner shard boundaries
    always exchange via ``ppermute`` (ICI); only the outermost shards consume
    the supplied halos.  ``None`` means silence beyond the span (a whole file).
    """
    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    M = bank.M
    n = mesh.shape["frames"]
    T = x.shape[-1]
    if T % (n * M):
        raise ValueError(f"frames {T} not a multiple of shards*M = {n * M}")
    # halo_right is clamped at 0: for heavy downsampling (small taps vs M,
    # e.g. lagrange beyond ~3x) W - M - halo_left goes negative, and an
    # unclamped value would ppermute nearly a whole chunk of useless frames.
    halo_left, halo_right = shard_halos(bank)
    chunk = T // n
    if max(halo_left, halo_right) > chunk:
        # resample_presliced's length check would reject this anyway (the
        # clipped halo slices leave xp shorter than one tile needs); raise
        # here with an actionable message instead of a shape error
        raise ValueError(
            f"per-shard chunk of {chunk} frames is smaller than the filter "
            f"halo ({max(halo_left, halo_right)}); use fewer frames shards "
            f"or pad the input (see required_frames_padding)")
    lead = x.shape[:-1]
    if left_halo is None:
        left_halo = jnp.zeros((*lead, halo_left), x.dtype)
    if right_halo is None:
        right_halo = jnp.zeros((*lead, halo_right), x.dtype)
    if left_halo.shape != (*lead, halo_left) or right_halo.shape != (*lead, halo_right):
        raise ValueError(
            f"outer halos must be {(*lead, halo_left)} / {(*lead, halo_right)}; "
            f"got {left_halo.shape} / {right_halo.shape}")
    return _resample_frames_sharded_impl(
        x, left_halo, right_halo, rate_in=rate_in, rate_out=rate_out,
        mesh=mesh, quality=quality, kind=kind)


@functools.partial(
    jax.jit, static_argnames=("rate_in", "rate_out", "quality", "kind", "mesh")
)
def _resample_frames_sharded_impl(
    x, outer_left, outer_right, *, rate_in, rate_out, mesh, quality, kind,
):
    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    M = bank.M
    halo_left, halo_right = shard_halos(bank)

    def local(xc, ol, orr):
        # xc: (..., T/n) local chunk.  Fetch halos from neighbours.
        axis = "frames"
        nsh = jax.lax.axis_size(axis)
        idx = jax.lax.axis_index(axis)
        parts = []
        if halo_left:
            # my leading `halo_left` frames come from the left neighbour's
            # tail -> shift tails one step to the RIGHT; shard 0 (which
            # ppermute fills with zeros) takes the caller-supplied context
            send_right = [(i, i + 1) for i in range(nsh - 1)]
            lh = jax.lax.ppermute(xc[..., -halo_left:], axis, send_right)
            lh = lh + jnp.where(idx == 0, ol, jnp.zeros_like(ol))
            parts.append(lh)
        parts.append(xc)
        if halo_right:
            # trailing lookahead from the right neighbour's head -> shift
            # heads LEFT; the last shard takes the supplied context
            send_left = [(i + 1, i) for i in range(nsh - 1)]
            rh = jax.lax.ppermute(xc[..., :halo_right], axis, send_left)
            rh = rh + jnp.where(idx == nsh - 1, orr, jnp.zeros_like(orr))
            parts.append(rh)
        xp = jnp.concatenate(parts, axis=-1)
        cycles = xc.shape[-1] // M
        return resample_presliced(xp, bank, cycles)

    nd = x.ndim
    spec = P(*([None] * (nd - 1) + ["frames"]))
    rep = P(*([None] * nd))
    return shard_map(local, mesh=mesh, in_specs=(spec, rep, rep),
                     out_specs=spec)(x, outer_left, outer_right)
