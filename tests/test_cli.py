"""CLI surface tests (the L6 layer), hermetic on CPU."""

import os

import numpy as np
import pytest

from f9tpu.cli import main
from f9tpu.io import read_wav, write_wav


def make_files(tmp_path, n=2, rate=44100):
    paths = []
    for i in range(n):
        t = np.arange(int(rate * 0.1)) / rate
        x = (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
        p = str(tmp_path / f"f{i}.wav")
        write_wav(p, np.stack([x, x]), rate, bits=24)
        paths.append(p)
    return paths


def test_cli_probe(tmp_path, capsys):
    paths = make_files(tmp_path, 1)
    assert main(["probe", paths[0]]) == 0
    out = capsys.readouterr().out
    assert "44100 Hz" in out and "2 ch" in out


def test_cli_probe_require_rate(tmp_path, capsys):
    paths = make_files(tmp_path, 1)
    main(["probe", paths[0], "--require-rate", "48000"])
    assert "INVALID" in capsys.readouterr().out


def test_cli_probe_pairs(tmp_path, capsys):
    """probe --pairs surfaces the reference's stereo-pair enumeration
    (Source/AppState.h:328-373) — VERDICT r3 missing #3."""
    import json as _json

    rng = np.random.default_rng(3)
    p6 = str(tmp_path / "bus6.wav")
    write_wav(p6, (0.2 * rng.standard_normal((6, 2000))).astype(np.float32),
              48000, bits=24)
    p1 = str(tmp_path / "mono.wav")
    write_wav(p1, (0.2 * rng.standard_normal((1, 2000))).astype(np.float32),
              48000, bits=24)
    assert main(["probe", p6, p1, "--pairs"]) == 0
    out = capsys.readouterr().out
    assert "stereo pairs (0-indexed): 0-1, 2-3, 4-5" in out
    assert "(none: fewer than 2 channels)" in out
    assert main(["probe", p6, "--pairs", "--json"]) == 0
    rows = _json.loads(capsys.readouterr().out)
    assert rows[0]["stereo_pairs"] == [[0, 1], [2, 3], [4, 5]]


def test_cli_process_directory(tmp_path, capsys):
    make_files(tmp_path, 2)
    out_dir = str(tmp_path / "out")
    rc = main([
        "process", str(tmp_path), "--out", out_dir,
        "--rate", "48000", "--quality", "low", "--json",
    ])
    assert rc == 0
    outs = sorted(os.listdir(out_dir))
    assert [o for o in outs if o.endswith(".wav")] == [
        "f0_processed.wav", "f1_processed.wav"]
    y, rate = read_wav(os.path.join(out_dir, "f0_processed.wav"))
    assert rate == 48000
    assert '"completed": 2' in capsys.readouterr().out


def test_cli_process_no_inputs(tmp_path, capsys):
    rc = main(["process", str(tmp_path / "empty_dir_glob*.wav"),
               "--out", str(tmp_path / "o")])
    assert rc == 2


def test_cli_preview(tmp_path, capsys):
    paths = make_files(tmp_path, 2)
    out = str(tmp_path / "playlist.wav")
    rc = main(["preview", *paths, "--out", out, "--rate", "44100",
               "--silence-ms", "100"])
    assert rc == 0
    y, rate = read_wav(out)
    n_item = int(44100 * 0.1)
    assert y.shape[-1] == 2 * n_item + 4410  # two items + one gap


def test_cli_preview_stream_flag_matches_in_memory(tmp_path, capsys):
    """preview --stream routes through the constant-memory renderer and
    emits the same samples as the in-memory form."""
    paths = make_files(tmp_path, 2)
    o1, o2 = str(tmp_path / "mem.wav"), str(tmp_path / "str.wav")
    common = ["--rate", "44100", "--silence-ms", "100"]
    assert main(["preview", *paths, "--out", o1, *common]) == 0
    assert main(["preview", *paths, "--out", o2, *common, "--stream"]) == 0
    assert "(streamed)" in capsys.readouterr().out
    y1, _ = read_wav(o1)
    y2, _ = read_wav(o2)
    np.testing.assert_array_equal(y1, y2)


def test_cli_measure(capsys):
    rc = main(["measure", "--rate-in", "44100", "--rate", "48000",
               "--quality", "low"])
    assert rc == 0
    assert "latency 0 frames" in capsys.readouterr().out


def test_cli_selftest(capsys):
    rc = main(["selftest", "--rate-in", "48000", "--rate", "44100",
               "--quality", "low"])
    assert rc == 0
    assert "loop_detected" in capsys.readouterr().out


def test_cli_stream(tmp_path):
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal((2, 44100))).astype(np.float32)
    src = str(tmp_path / "long.wav")
    write_wav(src, x, 44100, bits=24)
    out = str(tmp_path / "long48.wav")
    rc = main(["stream", src, "--out", out, "--rate", "48000",
               "--quality", "low", "--chunk-seconds", "0.25"])
    assert rc == 0
    y, rate = read_wav(out)
    assert rate == 48000 and y.shape == (2, 48000)


def test_cli_devices(capsys):
    rc = main(["devices"])
    assert rc == 0
    assert "device(s)" in capsys.readouterr().out


def test_cli_config_roundtrip(tmp_path, capsys):
    make_files(tmp_path, 1)
    out_dir = str(tmp_path / "out")
    cfgp = str(tmp_path / "settings.json")
    rc = main(["process", str(tmp_path), "--out", out_dir, "--rate", "48000",
               "--quality", "low", "--save-config", cfgp])
    assert rc == 0 and os.path.exists(cfgp)
    import json
    with open(cfgp) as f:
        saved = json.load(f)
    assert saved["rate"] == 48000 and saved["quality"] == "low"
    # config file supplies quality; CLI default would be "high"
    with open(cfgp, "w") as f:
        json.dump({"quality": "medium"}, f)
    rc = main(["process", str(tmp_path), "--out", str(tmp_path / "o2"),
               "--rate", "48000", "--config", cfgp, "--save-config",
               str(tmp_path / "resolved.json")])
    assert rc == 0
    with open(str(tmp_path / "resolved.json")) as f:
        assert json.load(f)["quality"] == "medium"


def test_cli_flag_beats_config_file(tmp_path):
    """Explicit command-line options must win over --config values."""
    make_files(tmp_path, 1)
    import json
    cfgp = str(tmp_path / "c.json")
    with open(cfgp, "w") as f:
        json.dump({"rate": 44100, "quality": "medium"}, f)
    rc = main(["process", str(tmp_path), "--out", str(tmp_path / "o"),
               "--config", cfgp, "--rate", "48000",
               "--save-config", str(tmp_path / "resolved.json")])
    assert rc == 0
    with open(str(tmp_path / "resolved.json")) as f:
        resolved = json.load(f)
    assert resolved["rate"] == 48000       # CLI flag won
    assert resolved["quality"] == "medium" # config supplied the default


def test_cli_uppercase_extension_dir(tmp_path):
    x = np.zeros((1, 1000), np.float32)
    write_wav(str(tmp_path / "LOUD.WAV"), x, 44100, bits=24)
    rc = main(["probe", str(tmp_path)])
    assert rc == 0


def test_cli_process_with_chain_and_seed(tmp_path):
    """--chain-delay-ms is measured+trimmed; --seed reruns byte-identical."""
    import numpy as np

    from f9tpu.io import wav

    src = tmp_path / "in"
    src.mkdir()
    t = np.arange(int(0.2 * 44100))
    x = (0.4 * np.sin(2 * np.pi * 330 * t / 44100)).astype(np.float32)
    wav.write_wav(str(src / "a.wav"), x[None], 44100, bits=24)

    outs = []
    for name in ("o1", "o2"):
        out = tmp_path / name
        rc = main([
            "process", str(src / "a.wav"), "--out", str(out),
            "--rate", "48000", "--quality", "low",
            "--chain-delay-ms", "50", "--seed", "9",
        ])
        assert rc == 0
        outs.append((out / "a_processed.wav").read_bytes())
    assert outs[0] == outs[1]
    got, rate = wav.read_wav(str(tmp_path / "o1" / "a_processed.wav"))
    assert rate == 48000
    # delay measured and trimmed: output length is the plain SRC length
    assert got.shape[1] == int(np.ceil(len(x) * 48000 / 44100))


def test_cli_preview_target_channels(tmp_path):
    import numpy as np

    from f9tpu.io import wav

    t = np.arange(4410)
    x = (0.4 * np.sin(2 * np.pi * 440 * t / 44100)).astype(np.float32)
    wav.write_wav(str(tmp_path / "a.wav"), x[None], 44100, bits=24)
    out = tmp_path / "bus.wav"
    rc = main([
        "preview", str(tmp_path / "a.wav"), "--out", str(out),
        "--rate", "44100", "--channels", "6", "--target-channels", "4,5",
    ])
    assert rc == 0
    got, _ = wav.read_wav(str(out))
    assert got.shape[0] == 6
    assert np.any(got[4] != 0) and np.all(got[0] == 0)


def test_cli_compile_cache_populated(tmp_path):
    """The CLI enables the persistent XLA compilation cache; with
    JAX_COMPILATION_CACHE_DIR set, a run leaves serialized executables
    there."""
    import subprocess
    import sys

    from f9tpu.io import write_wav

    (tmp_path / "in").mkdir()
    x = (0.1 * np.random.default_rng(0).standard_normal((1, 4410))).astype(np.float32)
    write_wav(str(tmp_path / "in" / "c.wav"), x, 44100, bits=24)
    cache = tmp_path / "xla_cache"
    # persist even sub-second compiles: on a warm machine the tiny test graph
    # can compile in <1 s and would otherwise skip the cache write (flaky)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    r = subprocess.run(
        [sys.executable, "-m", "f9tpu.cli", "process", str(tmp_path / "in"),
         "--out", str(tmp_path / "out"), "--rate", "48000",
         "--quality", "low", "--seed", "1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert cache.is_dir()
    entries = [f for _, _, fs in os.walk(cache) for f in fs]
    assert entries, "no executables were written to the compile cache"


@pytest.fixture
def _restore_cache_dir():
    import jax

    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_dir_left_to_jax(monkeypatch, _restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no cache directory
    of its own."""
    import jax

    from f9tpu.utils.compilecache import enable_compile_cache

    jax.config.update("jax_compilation_cache_dir", "/nonexistent/sentinel")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == "/nonexistent/sentinel"


def test_compile_cache_default_fixed_inside_checkout(monkeypatch,
                                                     _restore_cache_dir):
    """Without the variable the cache lands at <repo>/.jax_cache, which git
    ignores."""
    import jax

    from f9tpu.utils.compilecache import default_cache_dir, enable_compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    enable_compile_cache()
    assert default_cache_dir() == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == default_cache_dir()
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_probe_json_with_loudness(tmp_path, capsys):
    import json

    t = np.arange(48000) / 48000
    s = (0.1 * np.sin(2 * np.pi * 997 * t)).astype(np.float32)
    p = str(tmp_path / "j.wav")
    write_wav(p, np.stack([s, s]), 48000, bits=24)
    assert main(["probe", p, "--loudness", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 1
    r = rows[0]
    assert r["sample_rate"] == 48000 and r["channels"] == 2
    # stereo sine: +3 dB channel sum cancels the -3 dB RMS-vs-peak, and the
    # -0.691 offset cancels the K-gain at 997 Hz -> LUFS == peak dBFS
    assert -21 < r["lufs"] < -19
    assert "true_peak_db" in r and "lra_lu" in r


def test_cli_probe_json_keeps_stream_clean_on_error(tmp_path, capsys):
    """--json output must stay parseable when a file fails: errors become
    rows, not stray text."""
    import json

    good = str(tmp_path / "g.wav")
    write_wav(good, np.zeros((1, 1000), np.float32), 44100, bits=24)
    bad = str(tmp_path / "bad.wav")
    open(bad, "wb").write(b"RIFFgarbage")
    rc = main(["probe", good, bad, "--json"])
    assert rc == 1
    rows = json.loads(capsys.readouterr().out)    # must parse cleanly
    assert len(rows) == 2
    assert rows[0]["sample_rate"] == 44100
    assert "error" in rows[1]


def test_cli_probe_json_survives_device_side_failure(tmp_path, capsys,
                                                     monkeypatch):
    """Advisor round 2: with --loudness, a device-side failure (e.g. an
    XlaRuntimeError during metering) must become an error row for that file,
    not abort the whole probe run."""
    import json

    import f9tpu.ops.loudness as loud

    a = str(tmp_path / "a.wav")
    b = str(tmp_path / "b.wav")
    for p in (a, b):
        write_wav(p, (0.1 * np.random.default_rng(0)
                      .standard_normal((1, 48000))).astype(np.float32),
                  48000, bits=24)

    real = loud.r128_stats

    def flaky(x, rate, **kw):
        if flaky.calls == 0:
            flaky.calls += 1
            raise RuntimeError("XlaRuntimeError: RESOURCE_EXHAUSTED (fake)")
        return real(x, rate, **kw)

    flaky.calls = 0
    monkeypatch.setattr(loud, "r128_stats", flaky)
    rc = main(["probe", a, b, "--loudness", "--json"])
    assert rc == 1
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 2
    assert "RESOURCE_EXHAUSTED" in rows[0]["error"]
    assert rows[1]["lufs"] is not None


def test_cli_measure_with_chain(capsys):
    """measure takes the chain flags and reports the WHOLE loop's delay —
    a 10 ms pure delay at 48 kHz must measure as 480 frames (the reference
    measures the full hardware round trip, not just the transport)."""
    rc = main(["measure", "--rate-in", "44100", "--rate", "48000",
               "--quality", "low", "--chain-delay-ms", "10"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "latency 480 frames" in out and "SRC+chain" in out


def test_cli_selftest_parity(capsys):
    rc = main(["selftest", "--rate-in", "44100", "--rate", "48000",
               "--quality", "low", "--parity"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "loop_detected" in out and "parity:" in out and "[OK]" in out


def test_cli_watch_processes_landing_files(tmp_path):
    """watch: files landing in the folder are picked up once size-stable,
    processed through the normal pipeline, and deduped across sweeps."""
    import threading
    import time as _t

    indir = tmp_path / "drop"
    indir.mkdir()
    rng = np.random.default_rng(0)
    write_wav(str(indir / "first.wav"),
              (0.2 * rng.standard_normal((2, 4000))).astype(np.float32),
              44100, bits=24)

    def land_later():
        _t.sleep(0.25)
        write_wav(str(indir / "second.wav"),
                  (0.2 * rng.standard_normal((1, 3000))).astype(np.float32),
                  44100, bits=24)

    t = threading.Thread(target=land_later, daemon=True)
    t.start()
    rc = main(["watch", str(indir), "--out", str(tmp_path / "out"),
               "--rate", "48000", "--quality", "low", "--seed", "1",
               "--interval", "0.1", "--sweeps", "30"])
    t.join()
    assert rc == 0
    outs = sorted(os.listdir(tmp_path / "out"))
    assert "first_processed.wav" in outs and "second_processed.wav" in outs
    y, r = read_wav(str(tmp_path / "out" / "second_processed.wav"))
    assert r == 48000 and y.shape[1] > 0
    # the manifest recorded both with hashes (resume/verify compatible)
    import json as _json

    saved = _json.load(open(tmp_path / "out" / ".manifest.json"))
    assert all(row["status"] == "completed" and row["output_crc32"]
               for row in saved["files"])


def test_cli_watch_exits_after_idle(tmp_path):
    (tmp_path / "empty").mkdir()
    rc = main(["watch", str(tmp_path / "empty"), "--out",
               str(tmp_path / "out"), "--rate", "48000", "--quality", "low",
               "--interval", "0.05", "--exit-after-idle", "0.15"])
    assert rc == 0


def test_cli_watch_reprocesses_replaced_file(tmp_path):
    """A file re-dropped with NEW content (same name) must reprocess and
    overwrite the deliverable — the resume manifest alone would skip it."""
    import threading
    import time as _t

    indir = tmp_path / "drop"
    indir.mkdir()
    rng = np.random.default_rng(1)
    p = str(indir / "take.wav")
    write_wav(p, (0.2 * rng.standard_normal((1, 3000))).astype(np.float32),
              44100, bits=24)

    def replace_later():
        _t.sleep(0.4)
        write_wav(p, np.zeros((1, 3000), np.float32), 44100, bits=24)

    t = threading.Thread(target=replace_later, daemon=True)
    t.start()
    rc = main(["watch", str(indir), "--out", str(tmp_path / "out"),
               "--rate", "48000", "--quality", "low", "--seed", "1",
               "--no-dither", "--interval", "0.1", "--sweeps", "40"])
    t.join()
    assert rc == 0
    y, _ = read_wav(str(tmp_path / "out" / "take_processed.wav"))
    assert np.all(y == 0.0)       # the REPLACED (silent) content won


def test_cli_watch_restart_reprocesses_replaced_and_skips_unchanged(tmp_path):
    """Across a watch RESTART (in-memory done_sig lost): unchanged files must
    skip via the manifest (no rework), while a file replaced with new content
    while watch was down must reprocess — the manifest's stored input
    signature is what distinguishes them."""
    indir = tmp_path / "drop"
    indir.mkdir()
    rng = np.random.default_rng(3)
    keep = str(indir / "keep.wav")
    swap = str(indir / "swap.wav")
    write_wav(keep, (0.2 * rng.standard_normal((1, 3000))).astype(np.float32),
              44100, bits=24)
    write_wav(swap, (0.2 * rng.standard_normal((1, 3000))).astype(np.float32),
              44100, bits=24)
    argv = ["watch", str(indir), "--out", str(tmp_path / "out"),
            "--rate", "48000", "--quality", "low", "--seed", "1",
            "--no-dither", "--interval", "0.05", "--sweeps", "4"]
    assert main(argv) == 0
    out_keep = str(tmp_path / "out" / "keep_processed.wav")
    out_swap = str(tmp_path / "out" / "swap_processed.wav")
    keep_mtime = os.stat(out_keep).st_mtime_ns
    y, _ = read_wav(out_swap)
    assert not np.all(y == 0.0)
    # watch goes down; swap.wav is replaced with silent content
    write_wav(swap, np.zeros((1, 3000), np.float32), 44100, bits=24)
    assert main(argv) == 0               # restart: fresh done_sig
    y2, _ = read_wav(out_swap)
    assert np.all(y2 == 0.0)             # replaced content won
    assert os.stat(out_keep).st_mtime_ns == keep_mtime  # no rework


def test_cli_watch_picks_up_aiff(tmp_path):
    from f9tpu.io.aiff import write_aiff

    indir = tmp_path / "drop"
    indir.mkdir()
    rng = np.random.default_rng(2)
    write_aiff(str(indir / "take.aiff"),
               (0.2 * rng.standard_normal((2, 3000))).astype(np.float32),
               44100, bits=24)
    rc = main(["watch", str(indir), "--out", str(tmp_path / "out"),
               "--rate", "48000", "--quality", "low", "--seed", "1",
               "--interval", "0.05", "--sweeps", "20"])
    assert rc == 0
    y, r = read_wav(str(tmp_path / "out" / "take_processed.wav"))
    assert r == 48000 and y.shape[0] == 2


def test_cli_watch_full_batch_surface(tmp_path):
    """watch takes the full process option surface: an insert chain
    (--chain-eq), strict --require-rate, and --keep-metadata all reach the
    pipeline — the serving mode is not a feature-poor subset."""
    indir = tmp_path / "drop"
    indir.mkdir()
    rng = np.random.default_rng(4)
    good = str(indir / "good.wav")
    bad = str(indir / "bad.wav")
    write_wav(good, (0.2 * rng.standard_normal((1, 4000))).astype(np.float32),
              44100, bits=24)
    write_wav(bad, (0.2 * rng.standard_normal((1, 4000))).astype(np.float32),
              48000, bits=24)
    rc = main(["watch", str(indir), "--out", str(tmp_path / "out"),
               "--rate", "48000", "--quality", "low", "--seed", "1",
               "--require-rate", "44100", "--chain-eq", "lowpass:4000",
               "--interval", "0.05", "--sweeps", "4"])
    assert rc == 0
    outs = sorted(os.listdir(tmp_path / "out"))
    assert "good_processed.wav" in outs
    assert "bad_processed.wav" not in outs      # strict rate rejected it
    import json as _json

    saved = _json.load(open(tmp_path / "out" / ".manifest.json"))
    by_path = {row["path"]: row for row in saved["files"]}
    assert by_path[bad]["status"] == "invalid_sample_rate"
    assert by_path[good]["status"] == "completed"
    # the chain genuinely ran: compare against a chainless render
    rc = main(["process", good, "--out", str(tmp_path / "plain"),
               "--rate", "48000", "--quality", "low", "--seed", "1"])
    assert rc == 0
    y_chain, _ = read_wav(str(tmp_path / "out" / "good_processed.wav"))
    y_plain, _ = read_wav(str(tmp_path / "plain" / "good_processed.wav"))
    assert y_chain.shape == y_plain.shape
    assert not np.array_equal(y_chain, y_plain)


def test_cli_preview_quality_kind_plumbed(tmp_path):
    """preview --quality/--kind reach the mixed-rate resampler (a 96k item
    in a 44.1k playlist renders through the selected preset)."""
    from f9tpu.io import wav

    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal((1, 9600))).astype(np.float32)
    src = str(tmp_path / "hi.wav")
    wav.write_wav(src, x, 96000, bits=24)
    o1 = str(tmp_path / "p_high.wav")
    o2 = str(tmp_path / "p_lag.wav")
    assert main(["preview", src, "--out", o1, "--rate", "44100"]) == 0
    assert main(["preview", src, "--out", o2, "--rate", "44100",
                 "--quality", "low", "--kind", "lagrange"]) == 0
    y1, _ = read_wav(o1)
    y2, _ = read_wav(o2)
    assert y1.shape == y2.shape
    # different filter families genuinely produce different renders
    assert not np.array_equal(y1, y2)


def test_cli_watch_rejects_out_equals_dir(tmp_path, capsys):
    """--out == watched folder would self-feed (outputs picked up and
    reprocessed forever); refused at startup."""
    d = tmp_path / "drop"
    d.mkdir()
    rc = main(["watch", str(d), "--out", str(d), "--rate", "48000",
               "--quality", "low", "--interval", "0.05", "--sweeps", "1"])
    assert rc == 2
    assert "must differ" in capsys.readouterr().err


def test_cli_watch_rejects_invalid_config_at_startup(tmp_path, capsys):
    """Config errors fail at startup, not on the first drop hours later."""
    d = tmp_path / "drop"
    d.mkdir()
    rc = main(["watch", str(d), "--out", str(tmp_path / "out"), "--rate",
               "48000", "--quality", "low", "--normalize-tp", "-1",
               "--interval", "0.05", "--sweeps", "1"])
    assert rc == 2
    assert "invalid config" in capsys.readouterr().err


def test_cli_watch_survives_run_exception(tmp_path, monkeypatch, capsys):
    """A run-level failure (transient device/compile error) must not kill
    the serving daemon; the sweep logs FAILED and the loop continues."""
    import f9tpu.cli as cli_mod

    d = tmp_path / "drop"
    d.mkdir()
    write_wav(str(d / "x.wav"),
              (0.1 * np.random.default_rng(0).standard_normal((1, 3000))
               ).astype(np.float32), 44100, bits=24)

    class Boom:
        def __init__(self, *a, **k):
            pass

        def run(self, *a, **k):
            raise RuntimeError("calibration impulse not detected")

    monkeypatch.setattr(cli_mod, "BatchProcessor", Boom)
    rc = main(["watch", str(d), "--out", str(tmp_path / "out"), "--rate",
               "48000", "--quality", "low", "--interval", "0.05",
               "--sweeps", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "FAILED: calibration impulse not detected" in out
    # the loop kept sweeping after the failure (retry, not crash)
    assert out.count("FAILED") >= 2


def test_cli_watch_growing_file_is_not_idle(tmp_path, capsys):
    """A file still being copied in must reset the idle clock (old behavior
    exited mid-copy and dropped the file), and once it stabilizes it is
    processed; idle exit happens only after real quiet."""
    import time as _time

    d = tmp_path / "drop"
    d.mkdir()
    p = str(d / "grow.wav")
    rng = np.random.default_rng(1)
    x = (0.1 * rng.standard_normal((1, 3000))).astype(np.float32)

    calls = {"n": 0}
    real_sleep = _time.sleep

    def mutating_sleep(s):
        calls["n"] += 1
        if calls["n"] <= 4:
            # keep the file growing for the first sweeps (copy in progress)
            write_wav(p, x[:, : 1000 + 400 * calls["n"]], 44100, bits=24)
        real_sleep(min(s, 0.01))

    write_wav(p, x[:, :1000], 44100, bits=24)
    orig = _time.sleep
    _time.sleep = mutating_sleep
    try:
        rc = main(["watch", str(d), "--out", str(tmp_path / "out"), "--rate",
                   "48000", "--quality", "low", "--seed", "1", "--interval",
                   "0.2", "--exit-after-idle", "0.5", "--sweeps", "40"])
    finally:
        _time.sleep = orig
    assert rc == 0
    out = capsys.readouterr().out
    # the growing phase spans >= 4 intervals = 0.8s > exit-after-idle 0.5s:
    # an idle-exit before processing would leave no deliverable
    assert "grow_processed.wav" in "".join(os.listdir(tmp_path / "out"))
    assert "1 completed" in out


def test_cli_watch_aborted_sweep_retries_files(tmp_path, monkeypatch, capsys):
    """A device-dispatch abort (compile service outage) marks files FAILED
    inside the run, but the watch loop must NOT remember them as done:
    the next sweep retries and completes them once the device recovers."""
    import f9tpu.pipeline.scheduler as sched

    d = tmp_path / "drop"
    d.mkdir()
    write_wav(str(d / "x.wav"),
              (0.1 * np.random.default_rng(0).standard_normal((2, 4000))
               ).astype(np.float32), 44100, bits=24)

    real_raw = sched.process_batch_raw
    real = sched.process_batch
    calls = {"n": 0}

    def flaky_raw(*a, **k):
        calls["n"] += 1
        if calls["n"] <= 2:     # first flush + its one retry -> abort
            raise RuntimeError("INTERNAL: http 500 remote_compile (outage)")
        return real_raw(*a, **k)

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("INTERNAL: http 500 remote_compile (outage)")
        return real(*a, **k)

    monkeypatch.setattr(sched, "process_batch_raw", flaky_raw)
    monkeypatch.setattr(sched, "process_batch", flaky)
    monkeypatch.setattr(sched.time, "sleep", lambda s: None)
    rc = main(["watch", str(d), "--out", str(tmp_path / "out"), "--rate",
               "48000", "--quality", "low", "--seed", "1",
               "--interval", "0.05", "--sweeps", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ABORTED" in out                       # outage sweep surfaced
    # the retry sweep completed the file after the device recovered
    assert os.path.exists(tmp_path / "out" / "x_processed.wav")
    y, r = read_wav(str(tmp_path / "out" / "x_processed.wav"))
    assert r == 48000 and y.shape[1] > 0


def test_cli_preview_monitor_in_bus_without_monitor_out(tmp_path):
    """--monitor with --target-channels has a sink (the main bus): the
    mixdown must accumulate onto the monitoring channels even without a
    --monitor-out file (pre-fix --monitor alone was a silent no-op)."""
    src = str(tmp_path / "p.wav")
    write_wav(src, (0.2 * np.random.default_rng(1).standard_normal((2, 3000))
                    ).astype(np.float32), 48000, bits=24)
    out = str(tmp_path / "mix.wav")
    rc = main(["preview", src, "--out", out, "--rate", "48000",
               "--channels", "6", "--target-channels", "4,5", "--monitor",
               "--monitor-channels", "0,1"])
    assert rc == 0
    y, r = read_wav(out)
    assert r == 48000 and y.shape[0] == 6
    assert np.abs(y[0]).max() > 0 and np.abs(y[1]).max() > 0  # mixdown landed
    assert np.abs(y[4]).max() > 0 and np.abs(y[5]).max() > 0  # programme
    assert np.abs(y[2]).max() == 0 and np.abs(y[3]).max() == 0


def test_cli_preview_bad_target_channels_is_config_error(tmp_path, capsys):
    src = str(tmp_path / "q.wav")
    write_wav(src, (0.1 * np.random.default_rng(2).standard_normal((1, 2000))
                    ).astype(np.float32), 48000, bits=24)
    rc = main(["preview", src, "--out", str(tmp_path / "o.wav"), "--rate",
               "48000", "--target-channels", "4,x"])
    assert rc == 2
    assert "error" in capsys.readouterr().err
    # render_playlist's own validation surfaces the same way
    rc = main(["preview", src, "--out", str(tmp_path / "o.wav"), "--rate",
               "48000", "--channels", "2", "--target-channels", "0,0"])
    assert rc == 2


def test_output_never_overwrites_input(tmp_path):
    """--out == source dir with an empty postfix must suffix the deliverable
    away from the original (the reference's output-folder protection),
    never overwrite it."""
    src = str(tmp_path / "song.wav")
    x = (0.2 * np.random.default_rng(3).standard_normal((2, 4000))
         ).astype(np.float32)
    write_wav(src, x, 44100, bits=24)
    orig = open(src, "rb").read()
    rc = main(["process", src, "--out", str(tmp_path), "--postfix", "",
               "--rate", "48000", "--quality", "low", "--seed", "1"])
    assert rc == 0
    assert open(src, "rb").read() == orig          # original untouched
    out = tmp_path / "song_2.wav"
    assert out.exists()
    y, r = read_wav(str(out))
    assert r == 48000 and y.shape[1] == round(4000 * 48000 / 44100)


def test_stream_refuses_output_equals_input(tmp_path):
    from f9tpu.config import ProcessingConfig
    from f9tpu.pipeline import stream_resample_file

    src = str(tmp_path / "s.wav")
    write_wav(src, np.zeros((1, 4000), np.float32), 44100, bits=24)
    cfg = ProcessingConfig(output_dir=str(tmp_path), target_rate=48000,
                           quality="low")
    with pytest.raises(ValueError, match="destroy"):
        stream_resample_file(src, src, cfg)
    assert open(src, "rb").read()[:4] == b"RIFF"   # source intact


def test_config_validates_batch_size_and_channels():
    from f9tpu.config import ProcessingConfig

    with pytest.raises(ValueError, match="batch_size"):
        ProcessingConfig(output_dir="/tmp/x", batch_size=0).validate()
    with pytest.raises(ValueError, match="output_channels"):
        ProcessingConfig(output_dir="/tmp/x", output_channels=0).validate()


def test_cli_validation_errors_are_clean_exit_2(tmp_path, capsys):
    src = str(tmp_path / "v.wav")
    write_wav(src, np.zeros((1, 2000), np.float32), 44100, bits=24)
    rc = main(["process", src, "--out", str(tmp_path / "o"), "--rate",
               "48000", "--quality", "low", "--margin", "60"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "error:" in err and "margin" in err
    rc = main(["stream", src, "--out", str(tmp_path / "o.wav"), "--rate",
               "48000", "--quality", "low", "--margin", "60"])
    assert rc == 2


def test_cli_bad_routing_is_clean_error(tmp_path):
    src = str(tmp_path / "r.wav")
    write_wav(src, np.zeros((2, 2000), np.float32), 44100, bits=24)
    with pytest.raises(SystemExit):
        main(["process", src, "--out", str(tmp_path / "o"), "--routing",
              "0;x", "--rate", "48000"])


def test_cli_verify_missing_manifest_clean(tmp_path, capsys):
    rc = main(["verify", str(tmp_path / "nope.json")])
    assert rc == 2
    assert "cannot load manifest" in capsys.readouterr().err


def test_cli_glob_chars_in_literal_filename(tmp_path):
    src = str(tmp_path / "take[1].wav")
    write_wav(src, (0.1 * np.random.default_rng(4).standard_normal((1, 2000))
                    ).astype(np.float32), 44100, bits=24)
    rc = main(["process", src, "--out", str(tmp_path / "o"), "--rate",
               "48000", "--quality", "low", "--seed", "1"])
    assert rc == 0
    assert (tmp_path / "o" / "take[1]_processed.wav").exists()


def test_cli_missing_config_file_clean(tmp_path, capsys):
    src = str(tmp_path / "c.wav")
    write_wav(src, np.zeros((1, 1000), np.float32), 44100, bits=24)
    with pytest.raises(SystemExit) as ei:
        main(["process", src, "--out", str(tmp_path / "o"),
              "--config", str(tmp_path / "missing.json")])
    assert ei.value.code == 2
    assert "cannot load --config" in capsys.readouterr().err


def test_watch_churn_soak(tmp_path, monkeypatch):
    """Serving-mode churn soak: files drop, get replaced, and get deleted
    across many sweeps with one injected device outage — every surviving
    file ends COMPLETED with a verifiable deliverable, no file is ever
    half-published, and the daemon never wedges."""
    import threading
    import time as _t

    import f9tpu.pipeline.scheduler as sched

    d = tmp_path / "drop"
    d.mkdir()
    out = tmp_path / "out"
    rng = np.random.default_rng(77)

    def mk(name, seed, frames=3000):
        write_wav(str(d / name),
                  (0.2 * np.random.default_rng(seed)
                   .standard_normal((1, frames))).astype(np.float32),
                  44100, bits=24)

    mk("a.wav", 1)
    mk("b.wav", 2)

    real_raw = sched.process_batch_raw
    state = {"n": 0}

    def flaky(*a, **k):
        state["n"] += 1
        if state["n"] in (2, 3):       # one outage window (flush + retry)
            raise RuntimeError("INTERNAL: http 500 remote_compile (soak)")
        return real_raw(*a, **k)

    monkeypatch.setattr(sched, "process_batch_raw", flaky)
    monkeypatch.setattr(sched.time, "sleep", lambda s: None)

    def churn():
        _t.sleep(0.4)
        mk("c.wav", 3)                 # late drop
        _t.sleep(0.4)
        mk("b.wav", 20, frames=4000)   # replaced content
        _t.sleep(0.4)
        os.unlink(str(d / "a.wav"))    # removed from the folder

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    rc = main(["watch", str(d), "--out", str(out), "--rate", "48000",
               "--quality", "low", "--seed", "9", "--interval", "0.1",
               "--sweeps", "40"])
    t.join()
    assert rc == 0
    names = sorted(n for n in os.listdir(out) if n.endswith(".wav"))
    # a may or may not have completed before deletion; b and c must have,
    # with b reflecting the REPLACED content
    assert "b_processed.wav" in names and "c_processed.wav" in names
    assert not any(n.endswith(".part") for n in os.listdir(out))
    yb, rb = read_wav(str(out / "b_processed.wav"))
    assert rb == 48000 and yb.shape[1] == round(4000 * 48000 / 44100)
    # manifest audit: every completed entry verifies by content
    rc = main(["verify", str(out / ".manifest.json")])
    assert rc == 0


class TestJsonStdoutPurity:
    """--json promises machine-parseable stdout: the ONLY stdout bytes are
    the JSON document; the human log/progress moves to stderr."""

    def test_process_json_stdout_is_pure_json(self, tmp_path, capsys):
        import json as _json

        paths = make_files(tmp_path)
        rc = main(["process", *paths, "--out", str(tmp_path / "out"),
                   "--rate", "48000", "--quality", "low", "--seed", "1",
                   "--json"])
        assert rc == 0
        cap = capsys.readouterr()
        doc = _json.loads(cap.out)           # would raise on any log line
        assert doc["completed"] == 2
        assert "Batch start" in cap.err      # the log still exists, on stderr

    def test_stream_json_stdout_is_pure_json(self, tmp_path, capsys):
        import json as _json

        paths = make_files(tmp_path, n=1)
        out = str(tmp_path / "s.wav")
        rc = main(["stream", paths[0], "--out", out,
                   "--rate", "48000", "--quality", "low", "--seed", "1",
                   "--chunk-seconds", "0.02", "--json"])
        assert rc == 0
        cap = capsys.readouterr()
        doc = _json.loads(cap.out)
        assert doc["out_frames"] > 0

    def test_process_log_jsonl(self, tmp_path, capsys):
        import json as _json

        paths = make_files(tmp_path, n=1)
        jl = str(tmp_path / "events.jsonl")
        rc = main(["process", *paths, "--out", str(tmp_path / "out"),
                   "--rate", "48000", "--quality", "low", "--seed", "1",
                   "--log-jsonl", jl, "--json"])
        assert rc == 0
        events = [_json.loads(ln) for ln in open(jl)]
        assert any("Batch start" in e["msg"] for e in events)
        assert any("Completed" in e["msg"] for e in events)
        assert all("ts" in e for e in events)

    def test_stream_log_jsonl(self, tmp_path, capsys):
        """stream has the same structured journal as process/watch: typed
        stream_start/progress/completed events, stdout unchanged (--json
        stays pure)."""
        import json as _json

        paths = make_files(tmp_path, n=1)
        out = str(tmp_path / "s.wav")
        jl = str(tmp_path / "stream_events.jsonl")
        rc = main(["stream", paths[0], "--out", out,
                   "--rate", "48000", "--quality", "low", "--seed", "1",
                   "--chunk-seconds", "0.02", "--log-jsonl", jl, "--json"])
        assert rc == 0
        doc = _json.loads(capsys.readouterr().out)   # jsonl must not leak
        events = [_json.loads(ln) for ln in open(jl)]
        kinds = [e.get("event") for e in events]
        assert kinds[0] == "stream_start" and kinds[-1] == "completed"
        assert "progress" in kinds          # chunked run emits milestones
        done = events[-1]
        assert done["out_frames"] == doc["out_frames"] > 0
        assert done["output"] == out and done["wall_seconds"] >= 0
        assert all("ts" in e for e in events)

    def test_stream_log_jsonl_failed_event(self, tmp_path):
        """Every stream_start gets a terminal event: a mid-stream failure
        journals event=failed before the error surfaces."""
        import json as _json

        bad = tmp_path / "trunc.wav"
        good = make_files(tmp_path, n=1)[0]
        # truncated INSIDE the header (a half-copied drop): the reader's
        # ValueError surfaces after the journal's stream_start event.
        # (A truncated *payload* is not an error — readers clamp to the
        # bytes present and deliver a shorter file.)
        data = open(good, "rb").read()
        bad.write_bytes(data[:20])
        jl = str(tmp_path / "ev.jsonl")
        rc = main(["stream", str(bad), "--out", str(tmp_path / "o.wav"),
                   "--rate", "48000", "--quality", "low", "--seed", "1",
                   "--chunk-seconds", "0.02", "--log-jsonl", jl])
        assert rc != 0
        events = [_json.loads(ln) for ln in open(jl)]
        assert events[0]["event"] == "stream_start"
        assert events[-1]["event"] == "failed" and events[-1]["error"]


def test_watch_log_jsonl(tmp_path):
    """The serving daemon's structured journal: sweep events land in the
    JSONL file (append-only — a restart keeps the earlier history)."""
    import json as _json

    d = tmp_path / "inbox"; d.mkdir()
    x = (0.3 * np.random.default_rng(7).standard_normal((2, 3000))
         ).astype(np.float32)
    write_wav(str(d / "w.wav"), x, 44100, bits=24)
    jl = str(tmp_path / "watch_events.jsonl")
    common = ["--rate", "48000", "--quality", "low", "--seed", "3",
              "--interval", "0.05", "--sweeps", "3", "--log-jsonl", jl]
    rc = main(["watch", str(d), "--out", str(tmp_path / "o"), *common])
    assert rc == 0
    events = [_json.loads(ln) for ln in open(jl)]
    assert any("watch:" in e["msg"] for e in events)       # startup banner
    assert any("Completed" in e["msg"] for e in events)
    n_first = len(events)
    rc = main(["watch", str(d), "--out", str(tmp_path / "o"), *common])
    assert rc == 0
    events = [_json.loads(ln) for ln in open(jl)]
    assert len(events) > n_first                            # appended, not truncated


def test_watch_with_files_shards(tmp_path):
    """The serving daemon accepts the same mesh flags as process: a sweep
    under --files-shards (8 = the full virtual mesh) produces
    deliverables byte-identical to the
    unsharded daemon (dp invariance contract)."""
    from f9tpu.io import read_wav as _read

    d = tmp_path / "inbox"; d.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        x = (0.3 * rng.standard_normal((2, 3000))).astype(np.float32)
        write_wav(str(d / f"w{i}.wav"), x, 44100, bits=24)
    common = ["--rate", "48000", "--quality", "low", "--seed", "3",
              "--interval", "0.05", "--sweeps", "3"]
    rc = main(["watch", str(d), "--out", str(tmp_path / "o_dp"),
               "--files-shards", "8", *common])
    assert rc == 0
    rc = main(["watch", str(d), "--out", str(tmp_path / "o_1"), *common])
    assert rc == 0
    for i in range(2):
        a = open(tmp_path / "o_dp" / f"w{i}_processed.wav", "rb").read()
        b = open(tmp_path / "o_1" / f"w{i}_processed.wav", "rb").read()
        assert a == b


def test_cli_watch_picks_up_round5_formats(tmp_path):
    """The watch daemon's drop-zone accepts the FULL round-5 input
    surface: .ogg, .caf (ALAC) and .m4a sources land and process like
    WAV/AIFF/FLAC ones."""
    import avref
    import vorbis_ref

    if not (avref.available() and vorbis_ref.available()):
        pytest.skip("reference encoders unavailable")
    indir = tmp_path / "drop"
    indir.mkdir()
    rng = np.random.default_rng(9)
    x = (0.2 * rng.standard_normal((2, 5000))).astype(np.float32)
    codes = np.clip((x * (1 << 23)), -(1 << 23),
                    (1 << 23) - 1).astype(np.int64)
    with open(indir / "v.ogg", "wb") as f:
        f.write(vorbis_ref.encode_ogg(x, 44100, 0.4))
    avref.encode_file("alac", str(indir / "a.caf"), "caf", codes, 44100, 24)
    avref.encode_file("alac", str(indir / "m.m4a"), "ipod", codes, 44100, 24)
    rc = main(["watch", str(indir), "--out", str(tmp_path / "out"),
               "--rate", "48000", "--quality", "low", "--seed", "1",
               "--interval", "0.05", "--sweeps", "30"])
    assert rc == 0
    outs = sorted(os.listdir(tmp_path / "out"))
    for stem in ("v", "a", "m"):
        assert f"{stem}_processed.wav" in outs, outs
    # the CAF and M4A sources hold the SAME samples: with the same seed
    # their deliverables differ only by the path-keyed dither
    ya, _ = read_wav(str(tmp_path / "out" / "a_processed.wav"))
    ym, _ = read_wav(str(tmp_path / "out" / "m_processed.wav"))
    assert ya.shape == ym.shape


def test_cli_preview_accepts_ogg_items(tmp_path):
    """Preview playlists mix .ogg items with WAV ones (the reference's
    preview plays anything its format manager reads)."""
    import vorbis_ref

    if not vorbis_ref.available():
        pytest.skip("libvorbis unavailable")
    rng = np.random.default_rng(3)
    x = (0.2 * rng.standard_normal((1, 6000))).astype(np.float32)
    a = str(tmp_path / "a.wav")
    write_wav(a, x, 44100, bits=24)
    b = str(tmp_path / "b.ogg")
    with open(b, "wb") as f:
        f.write(vorbis_ref.encode_ogg(x, 44100, 0.4))
    out = str(tmp_path / "mix.wav")
    rc = main(["preview", a, b, "--out", out, "--rate", "44100",
               "--quality", "low", "--silence-ms", "10"])
    assert rc == 0
    y, r = read_wav(out)
    assert r == 44100 and y.shape[0] == 2
    from f9tpu.io import probe
    from f9tpu.pipeline.preview import playlist_item_frames

    want = (playlist_item_frames(a, 44100)
            + playlist_item_frames(b, 44100) + 441)
    assert probe(out).num_frames == want
