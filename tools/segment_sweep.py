"""Segment-count / chunk-size sweep of the raw pitch step on the GPU.

Re-measures the scaling map behind `models/segmented.auto_segments` —
worth re-running whenever the step's device-memory footprint changes.

Usage: python tools/segment_sweep.py [--configs 64x256,64x512,...]
Prints one JSON line {config: frames_per_s}; notes on stderr.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="64x256,128x128,128x256,64x512,"
                                         "32x512,128x512,256x128")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--backend", default=None,
                    help="STFT backend (ops/stft.py; default = package "
                         "default)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from audio_analyzer_rs_tpu.models import generators as gen
    from audio_analyzer_rs_tpu.models.segmented import _vmapped_step
    from audio_analyzer_rs_tpu.ops import noisefloor, tracker
    from audio_analyzer_rs_tpu.ops.stft import PITCH_BACKEND

    sr = 44100.0
    window, hop = 2048, 512
    half = window // 2 + 1
    backend = args.backend or PITCH_BACKEND
    results = {"backend": backend}

    for cfgs in args.configs.split(","):
        segs, cf = (int(v) for v in cfgs.split("x"))
        chunk_samples = (cf - 1) * hop + window
        audio = gen.mixed_scene(chunk_samples / sr + 1.0, sr, seed=2)
        seg_audio = jnp.broadcast_to(
            jnp.asarray(audio[:chunk_samples]), (segs, chunk_samples))

        def rep(s):
            return jax.tree.map(
                lambda a: jnp.broadcast_to(a, (segs,) + a.shape), s)

        nf_s = rep(noisefloor.init_state(half))
        tr_s = rep(tracker.init_state())
        gf = jnp.full((segs, cf), 1e-3, jnp.float32)
        on = jnp.zeros((segs, cf), bool)

        # The bench's lean vmapped step (stable-pitch outputs only).
        def f():
            return _vmapped_step(nf_s, tr_s, seg_audio, gf, on, sr,
                                 window, hop, backend)
        try:
            t0 = time.perf_counter()
            outs = f()
            np.asarray(outs[2].stable_valid).sum()
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(args.iters):
                outs = f()
            np.asarray(outs[2].stable_valid).sum()
            dt = (time.perf_counter() - t0) / args.iters
            fps = segs * cf / dt
            results[cfgs] = round(fps, 0)
            print(f"{cfgs:>9s}: {dt*1000:8.2f} ms  {fps:12,.0f} frames/s"
                  f"  (compile {compile_s:.1f}s)", file=sys.stderr)
        except Exception as e:
            results[cfgs] = str(e).splitlines()[0][:80]
            print(f"{cfgs:>9s}: FAIL {results[cfgs]}", file=sys.stderr)
        finally:
            jax.clear_caches()

    print(json.dumps(results))


if __name__ == "__main__":
    main()
