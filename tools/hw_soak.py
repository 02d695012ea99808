"""Hardware soak: the chain/stream byte-exactness fuzzes on the GPU.

The CPU suite cannot see numerics that belong to the card: cuBLAS and cuDNN
may pick another algorithm for each shape, and the GPU compiler contracts
multiply-adds into FMAs where a fusion boundary allows.  This entry point
re-runs the byte-exactness properties on the card:

1. a pinned repro (FIRInsert 64 taps @ 997-frame chunks; Biquad peaking
   1 kHz q=2 +6 dB, 858-tap IR, @ 997 and 4096) — whole-signal apply vs
   streamed, 0 ULP, plus 24-bit code equality;
2. fresh-seed random chain stacks through `Chain.apply_stream`
   (tests/test_chain.py fuzz body, every built-in stage in the pool);
3. fresh-seed end-to-end streaming configs through `stream_resample_file`
   (tests/test_fuzz_configs.py body) — on the GPU the emitted bytes must be
   EXACTLY chunk-size invariant (the fuzz's last-ulp allowance holds only on
   the CPU backend).

Needs an NVIDIA GPU and fails without one.  Usage (minutes):

    python tools/hw_soak.py [--seed S] [--chain-trials N] [--stream-trials N]

Exits non-zero on any divergence; prints a one-line summary for PERF.md.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _test_module(name: str):
    """``tests/<name>.py`` loaded by path: a ``tests`` package installed in
    site-packages would shadow the repo's own test directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_soak_{name}", os.path.join(REPO, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pinned_repro() -> None:
    """A pinned FIR/biquad streaming repro, as a hard gate."""
    from f9tpu.ops.chain import Biquad, Chain, FIRInsert

    rate = 48000
    rng = np.random.default_rng(40)
    T = 80000
    x = (0.5 * rng.standard_normal((2, T))).astype(np.float32)
    chains = [
        ("fir64", Chain(FIRInsert(rng.standard_normal(64).astype(np.float32)))),
        ("biquad_peak1k_q2", Chain(Biquad("peaking", 1000.0, 2.0, 6.0))),
    ]
    for name, chain in chains:
        whole = np.asarray(chain.apply(jnp.asarray(x), rate))
        runs = []
        for chunk in (997, 4096):
            st = chain.stream_init(rate, 2)
            outs, pos = [], 0
            while pos < T:
                seg = x[:, pos:pos + chunk]
                o, st = chain.apply_stream(jnp.asarray(seg), st, rate,
                                           jnp.int32(pos))
                outs.append(np.asarray(o))
                pos += seg.shape[1]
            runs.append(np.concatenate(outs, axis=1))
        for i, got in enumerate(runs):
            bad = int((whole != got).sum())
            codes = int((np.round(whole * (1 << 23))
                         != np.round(got * (1 << 23))).sum())
            assert bad == 0, (name, i, "float diffs", bad, "code diffs", codes)
        assert np.array_equal(runs[0], runs[1]), (name, "chunk-size variant")
        print(f"  pinned repro [{name}]: 0 ULP whole-vs-streamed @997 & @4096")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=int(time.time()) % 100000)
    ap.add_argument("--chain-trials", type=int, default=8)
    ap.add_argument("--stream-trials", type=int, default=4)
    args = ap.parse_args()

    from f9tpu.utils.compilecache import enable_compile_cache
    from f9tpu.utils.device import card_lines, require_gpu

    devs = require_gpu("hw_soak")
    enable_compile_cache()
    backend = devs[0].platform
    for line in card_lines():
        print(line)
    print(f"hw_soak: backend={backend} kind={devs[0].device_kind} "
          f"devices={devs} seed={args.seed}")

    t0 = time.time()
    print("[1/3] pinned FIR/biquad streaming repro...")
    pinned_repro()

    print(f"[2/3] chain fuzz: {args.chain_trials} fresh-seed stacks...")
    _test_module("test_chain").test_chain_apply_stream_fuzz_random_stacks(
        seed=args.seed, trials=args.chain_trials)
    print("  chain fuzz: all stacks 0 ULP")

    print(f"[3/3] streaming e2e fuzz: {args.stream_trials} configs...")
    from pathlib import Path

    fuzz = _test_module("test_fuzz_configs")
    for t in range(args.stream_trials):
        with tempfile.TemporaryDirectory() as d:
            fuzz.test_random_streaming_config_end_to_end(
                Path(d), trial=args.seed + 13 * t)
        print(f"  stream trial {t}: bytes chunk-size invariant")

    dt = time.time() - t0
    print(f"hw_soak PASS: backend={backend} seed={args.seed} "
          f"chain_trials={args.chain_trials} stream_trials={args.stream_trials} "
          f"wall={dt:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
