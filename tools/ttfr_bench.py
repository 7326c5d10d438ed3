"""Time-to-first-result (TTFR) for the framework's four entry points.

The reference starts analyzing within milliseconds of spawn — its init is a
device probe plus thread spawns (ref src/audio_io/mod.rs:226-334).  The
rebuild pays XLA compiles per program geometry instead; this tool makes that
cost visible and measurable so it can be paid at install time:

  entry points: live engine streaming (with and without engine.prepare()),
                analysis.analyze_buffer, models.segmented single-recording,
                models.segmented batch.

Each entry point runs in a FRESH subprocess (empty in-process jit cache),
with the persistent compile cache enabled (JAX_COMPILATION_CACHE_DIR if
set, else the repo's .jax_cache) — so "first_s" is the persistent-cache-hit
number a user sees after one warmed run (or after `engine.prepare()` / this
tool has been run once at install time), and "steady_s" is the second call
in the same process.  For a truly cold measurement pass --cache-dir to an
empty directory.

Usage: python tools/ttfr_bench.py [--cpu] [--cache-dir DIR] [--only NAME]
Prints a markdown table on stderr and one JSON line on stdout.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = """
import json, time, sys, os
sys.path.insert(0, {root!r})
import jax
if {cpu!r} == "1":
    jax.config.update("jax_platforms", "cpu")
if {cache!r}:
    from audio_analyzer_rs_tpu.compile_cache import configure_compile_cache
    configure_compile_cache()
import numpy as np
from audio_analyzer_rs_tpu.models import generators as gen
jax.devices()   # exclude backend init from the measured numbers
"""

SCRIPTS = {
    # Live engine: first slot-with-results wall time, then steady state.
    "engine_stream": COMMON + """
from audio_analyzer_rs_tpu.api.device import ArraySource
from audio_analyzer_rs_tpu.api.engine import AudioEngine
sr = 48000.0
scene = gen.mixed_scene(12.0, sr, seed=11)
e = AudioEngine(input_source=ArraySource(scene), sample_rate=sr,
                loopback_latency_samples=2048, loopback_gain=1.0)
t_prep = 0.0
if {prepare!r} == "1":
    t0 = time.perf_counter(); e.prepare(); t_prep = time.perf_counter() - t0
tuner = e.start_tuner(); onset = e.start_onset_detection()
slot_s = e.buffer_size / sr
t0 = time.perf_counter()
for _ in range(4):          # ramp-up: all per-slot program variants compile
    e.advance(slot_s)
first = time.perf_counter() - t0
t0 = time.perf_counter()
for _ in range(16):
    e.advance(slot_s)
steady = (time.perf_counter() - t0) / 16
print(json.dumps({{"first_s": first, "steady_s": steady,
                   "prepare_s": t_prep}}))
""",
    "analyze_buffer": COMMON + """
from audio_analyzer_rs_tpu.analysis import analyze_buffer
sr = 44100.0
x = gen.mixed_scene(2.0, sr, seed=11)
t0 = time.perf_counter()
r = analyze_buffer(x, sr, as_arrays=True)
first = time.perf_counter() - t0
t0 = time.perf_counter()
r = analyze_buffer(x, sr, as_arrays=True)
steady = time.perf_counter() - t0
print(json.dumps({{"first_s": first, "steady_s": steady}}))
""",
    "segmented": COMMON + """
from audio_analyzer_rs_tpu.models.segmented import segmented_pitch_analysis
sr = 44100.0
x = gen.mixed_scene(300.0, sr, seed=11)
t0 = time.perf_counter()
r = segmented_pitch_analysis(x, sr)
first = time.perf_counter() - t0
t0 = time.perf_counter()
r = segmented_pitch_analysis(x, sr)
steady = time.perf_counter() - t0
print(json.dumps({{"first_s": first, "steady_s": steady}}))
""",
    "batch": COMMON + """
from audio_analyzer_rs_tpu.models.segmented import (
    segmented_pitch_analysis_batch)
sr = 44100.0
takes = [gen.mixed_scene(t, sr, seed=s)
         for t, s in ((6.0, 1), (11.0, 2), (3.5, 3))]
t0 = time.perf_counter()
r = segmented_pitch_analysis_batch(takes, sr)
first = time.perf_counter() - t0
t0 = time.perf_counter()
r = segmented_pitch_analysis_batch(takes, sr)
steady = time.perf_counter() - t0
print(json.dumps({{"first_s": first, "steady_s": steady}}))
""",
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent compile cache directory (default: "
                         "JAX_COMPILATION_CACHE_DIR or the repo's "
                         ".jax_cache; '' disables)")
    ap.add_argument("--only", default=None,
                    help="run a single entry point by name")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from audio_analyzer_rs_tpu.compile_cache import ENV_VAR, cache_dir
    env = dict(os.environ)
    if args.cache_dir is None:
        args.cache_dir = cache_dir()
    elif args.cache_dir:
        env[ENV_VAR] = args.cache_dir
    else:
        env.pop(ENV_VAR, None)

    results = {}
    runs = []
    for name in SCRIPTS:
        if args.only in (None, name):
            runs.append((name, {}))
            if name == "engine_stream":
                # Second variant: the prepare() precompile pass up front.
                runs.append(("engine_stream+prepare",
                             {"base": "engine_stream", "prepare": "1"}))

    for name, opts in runs:
        base = opts.get("base", name)
        script = SCRIPTS[base].format(
            root=ROOT, cpu="1" if args.cpu else "0",
            cache=args.cache_dir or "", prepare=opts.get("prepare", "0"))
        log(f"[{name}] running in fresh subprocess ...")
        proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                              capture_output=True, text=True, env=env)
        if proc.returncode != 0:
            log(proc.stderr[-2000:])
            results[name] = {"error": proc.returncode}
            continue
        data = json.loads(proc.stdout.strip().splitlines()[-1])
        results[name] = {k: round(v, 3) for k, v in data.items()}
        log(f"[{name}] {results[name]}")

    log("\n| Entry point | first call (fresh process, persistent cache) "
        "| steady state |")
    log("|---|---|---|")
    for name, r in results.items():
        if "error" in r:
            log(f"| {name} | ERROR | |")
            continue
        extra = (f" (+{r['prepare_s']}s prepare)" if r.get("prepare_s")
                 else "")
        log(f"| {name} | {r['first_s']} s{extra} | {r['steady_s']} s |")
    print(json.dumps({"cache_dir": args.cache_dir, "cpu": args.cpu,
                      "results": results}))


if __name__ == "__main__":
    main()
