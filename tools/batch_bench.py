"""Measure batched multi-recording throughput (the serving workload).

A single short take (~30 s practice recording) only fans out to ~2 segments
(auto_segments payload rule), so analyzing takes one-by-one leaves the chip
mostly idle AND pays per-call dispatch/upload latency per take.
`segmented_pitch_analysis_batch` packs RECORDINGS x SEGMENTS into one flat
row axis at the 128-row device geometry.  This measures both paths on the
default JAX device:

  one_by_one : sum of `segmented_pitch_analysis(take)` walls (second pass —
               compiles amortized; each call still uploads its own take)
  batched    : one `segmented_pitch_analysis_batch(takes)` wall (second
               pass; one packed upload, one program)

Usage: python tools/batch_bench.py [--takes 64] [--seconds 30] [--cpu]
         [--skip-onset]
Prints one JSON line; notes on stderr.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--takes", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip-onset", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from audio_analyzer_rs_tpu.models import generators as gen
    from audio_analyzer_rs_tpu.models.segmented import (
        segmented_onset_analysis, segmented_onset_analysis_batch,
        segmented_pitch_analysis, segmented_pitch_analysis_batch)
    from audio_analyzer_rs_tpu.utils.framing import num_frames

    sr = 44100.0
    t0 = time.time()
    takes = [np.clip(gen.mixed_scene(args.seconds, sr, seed=k) * 32768.0,
                     -32768, 32767).astype(np.int16)
             for k in range(args.takes)]
    n_pitch = sum(num_frames(len(t), 2048, 512) for t in takes)
    n_onset = sum(num_frames(len(t), 256, 64) for t in takes)
    mb = sum(len(t) for t in takes) * 2 / 1e6
    log(f"{args.takes} takes x {args.seconds:g}s = {mb:.0f} MB int16, "
        f"{n_pitch:,} pitch frames ({time.time()-t0:.1f}s to render)")

    results = {"takes": args.takes, "seconds": args.seconds}

    def run(tag, fn, n_frames):
        t0 = time.time()
        fn()
        cold = time.time() - t0
        t0 = time.time()
        fn()
        dt = time.time() - t0
        results[tag + "_s"] = round(dt, 2)
        results[tag + "_fps"] = round(n_frames / dt)
        log(f"{tag:24s} {dt:7.2f}s -> {n_frames/dt:10,.0f} frames/s "
            f"(first {cold:.1f}s)")

    run("pitch_batched",
        lambda: segmented_pitch_analysis_batch(takes, sr), n_pitch)
    run("pitch_one_by_one",
        lambda: [segmented_pitch_analysis(t, sr) for t in takes], n_pitch)
    if not args.skip_onset:
        run("onset_batched",
            lambda: segmented_onset_analysis_batch(takes, sr), n_onset)
        run("onset_one_by_one",
            lambda: [segmented_onset_analysis(t, sr) for t in takes],
            n_onset)
    results["pitch_speedup"] = round(
        results["pitch_one_by_one_s"] / results["pitch_batched_s"], 2)
    if not args.skip_onset:
        results["onset_speedup"] = round(
            results["onset_one_by_one_s"] / results["onset_batched_s"], 2)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
