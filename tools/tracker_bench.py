"""Time the Pallas tracker kernel against the XLA scan, alone and end to end.

Alone: `tracker_scan_batched` at the segmented step's geometry (128
segments x 64 frames by default) on realistic raw pitches, for the XLA scan
(`impl="xla"`) and the kernel at each block size in `--block-streams`.
Each variant is checked against the XLA scan first: integer and boolean
outputs exactly, frequencies in ulps.

End to end: `segmented_pitch_analysis` of an hour of int16 audio
(`generators.mixed_scene`) with the tracker forced to each implementation,
timed in the order xla, kernel, kernel, xla after a warm-up run of each.

Usage: python tools/tracker_bench.py [--segments 128] [--chunk-frames 64]
       [--iters 50] [--block-streams 1,2,4,8,16,32] [--e2e-seconds 3600]
Needs a GPU.  Prints one JSON line last; per-row notes on stderr.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def ulp_diff(a, b):
    """Largest distance in units in the last place between two f32 arrays."""
    import numpy as np
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--segments", type=int, default=128)
    ap.add_argument("--chunk-frames", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--block-streams", default="1,2,4,8,16,32")
    ap.add_argument("--e2e-seconds", type=float, default=3600.0)
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    import jax
    import jax.numpy as jnp
    import numpy as np

    from audio_analyzer_rs_tpu.compile_cache import configure_compile_cache
    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    from audio_analyzer_rs_tpu.models import generators as gen
    from audio_analyzer_rs_tpu.models import segmented
    from audio_analyzer_rs_tpu.ops import tracker
    from audio_analyzer_rs_tpu.ops.pallas_tracker import tracker_scan_pallas
    from audio_analyzer_rs_tpu.ops.pitch import MAX_NOTES

    results = {"device": dev.device_kind, "card": card.strip(),
               "segments": args.segments, "chunk_frames": args.chunk_frames}
    log(f"device {dev.device_kind}; card {card.strip()}")

    segs, cf = args.segments, args.chunk_frames
    rng = np.random.default_rng(7)
    # ~2.5 valid pitches per frame with frame-to-frame continuity, so tracks
    # form and the match paths are hot; ~5% onset frames.
    n_valid = rng.integers(0, 5, size=(segs, cf))
    valid = np.arange(MAX_NOTES)[None, None, :] < n_valid[..., None]
    base = rng.uniform(80.0, 900.0, size=(segs, 1, MAX_NOTES))
    drift = np.cumsum(rng.normal(0, 0.002, (segs, cf, MAX_NOTES)), axis=1)
    raws = (jnp.asarray((base * np.exp(drift)).astype(np.float32)),
            jnp.asarray(rng.uniform(0.1, 4.0, (segs, cf, MAX_NOTES))
                        .astype(np.float32)),
            jnp.asarray(valid), jnp.asarray(rng.random((segs, cf)) < 0.05))
    st0 = jax.tree.map(lambda a: jnp.broadcast_to(a, (segs,) + a.shape),
                       tracker.init_state())

    def time_fn(f):
        out = jax.block_until_ready(f(st0, *raws))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = f(st0, *raws)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / args.iters, out

    xla = jax.jit(lambda *a: tracker.tracker_scan_batched(*a, impl="xla"))
    dt_x, ref = time_fn(xla)
    ref = jax.tree.map(np.asarray, ref)
    results["alone_xla_ms"] = dt_x * 1e3
    log(f"alone xla          {dt_x * 1e3:9.4f} ms")
    best = None
    for bs in [int(v) for v in args.block_streams.split(",") if v]:
        fn = jax.jit(lambda *a, bs=bs: tracker_scan_pallas(
            *a, block_streams=bs))
        dt, out = time_fn(fn)
        out = jax.tree.map(np.asarray, out)
        st, (f, s, v) = out
        exact = (np.array_equal(v, ref[1][2]) and np.array_equal(s, ref[1][1])
                 and all(np.array_equal(getattr(st, k), getattr(ref[0], k))
                         for k in ("score", "life", "valid", "seq",
                                   "next_seq")))
        ulps = max(ulp_diff(f, ref[1][0]), ulp_diff(st.freq, ref[0].freq))
        results[f"alone_pallas_bs{bs}_ms"] = dt * 1e3
        results[f"alone_pallas_bs{bs}_exact"] = bool(exact)
        results[f"alone_pallas_bs{bs}_freq_ulps"] = ulps
        log(f"alone pallas bs={bs:<3d} {dt * 1e3:9.4f} ms  exact={exact} "
            f"freq_ulps={ulps}")
        if exact and ulps <= 1 and (best is None or dt < best[1]):
            best = (bs, dt)
    results["alone_best_block_streams"] = best and best[0]

    if args.e2e_seconds > 0:
        audio = gen.mixed_scene(args.e2e_seconds, 44100.0, seed=0)
        audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        orig = tracker.tracker_scan_batched

        def run(impl):
            tracker.tracker_scan_batched = (
                lambda *a, **k: orig(*a, impl=impl, **k))
            segmented._vmapped_step_resident.clear_cache()
            segmented._vmapped_step.clear_cache()
            try:
                segmented.segmented_pitch_analysis(audio, 44100.0)  # warm
                t0 = time.perf_counter()
                out = segmented.segmented_pitch_analysis(audio, 44100.0)
                return time.perf_counter() - t0, out
            finally:
                tracker.tracker_scan_batched = orig

        times = {"xla": [], "pallas": []}
        outs = {}
        for impl in ("xla", "pallas", "pallas", "xla"):
            dt, outs[impl] = run(impl)
            times[impl].append(dt)
            log(f"e2e {args.e2e_seconds:.0f} s pitch, tracker={impl:6s} "
                f"{dt:8.4f} s")
        agree = float(np.mean(np.all(
            outs["xla"][2] == outs["pallas"][2], axis=1)))
        results["e2e_seconds_xla"] = times["xla"]
        results["e2e_seconds_pallas"] = times["pallas"]
        results["e2e_stable_frame_agreement"] = agree
        log(f"e2e stable-frame agreement xla vs pallas: {agree:.6%}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
