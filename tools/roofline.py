"""Roofline accounting for the headline pitch-pipeline step.

Lowers the segment-parallel step (the bench configuration) and reads XLA's
own cost analysis (FLOPs + bytes accessed), then combines it with a
measured steady-state step time to report achieved FLOP/s and HBM
bandwidth versus the card's published peaks (PEAKS, keyed by
`device_kind`; a card missing from the table is an error).  The peaks
assume the card's full power limit; `nvidia-smi` reports the limit the
card runs at.

Usage: python tools/roofline.py [--segments 64] [--chunk-frames 256]
Needs a GPU.  Prints one JSON line; notes on stderr.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published dense peaks (NVIDIA H100 data sheet, SXM part, 700 W).  This
# pipeline is float32: its matmuls run at HIGHEST precision, off the TF32
# tensor-core rate.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_tflops": 67.0, "tf32_tflops": 495.0,
                              "hbm_gbs": 3350.0,
                              "source": "NVIDIA H100 data sheet (SXM)"},
}


def peaks_for(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise SystemExit(f"no published peaks for {device_kind!r}; add them "
                         "to tools/roofline.py PEAKS") from None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--segments", type=int, default=64)
    ap.add_argument("--chunk-frames", type=int, default=256)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from audio_analyzer_rs_tpu.models import generators as gen
    from audio_analyzer_rs_tpu.models.segmented import _vmapped_step
    from audio_analyzer_rs_tpu.ops import noisefloor, tracker

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"roofline needs a GPU; JAX found {dev.platform!r}")
    peaks = peaks_for(dev.device_kind)

    sr = 44100.0
    window, hop = 2048, 512
    segs, cf = args.segments, args.chunk_frames
    chunk_samples = (cf - 1) * hop + window
    frames_per_step = segs * cf

    def rep(state):
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (segs,) + a.shape), state)
    nf = rep(noisefloor.init_state(window // 2 + 1))
    tr = rep(tracker.init_state())
    base = gen.tone_with_harmonics(220.0, chunk_samples / sr, sr,
                                   harmonics=10,
                                   amplitude=0.4)[:chunk_samples]
    audio = jnp.broadcast_to(jnp.asarray(base), (segs, chunk_samples))
    gf = jnp.full((segs, cf), 1e-3, jnp.float32)
    on = jnp.zeros((segs, cf), bool)

    lowered = _vmapped_step.lower(nf, tr, audio, gf, on, sr, window, hop)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):   # some jax versions wrap per-device
        cost = cost[0]
    flops = float(cost.get("flops", float("nan")))
    # XLA reports bytes accessed (HBM traffic incl. re-reads of fused
    # operands at their materialization points).
    bytes_acc = float(cost.get("bytes accessed", float("nan")))

    # Measured steady-state step time.
    jax.block_until_ready(_vmapped_step(nf, tr, audio, gf, on, sr, window,
                                        hop))
    iters = 12
    t0 = time.perf_counter()
    state = (nf, tr)
    for _ in range(iters):
        n2, t2, out = _vmapped_step(state[0], state[1], audio, gf, on,
                                    sr, window, hop)
        state = (n2, t2)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    fps = frames_per_step / dt

    flops_frame = flops / frames_per_step
    bytes_frame = bytes_acc / frames_per_step
    achieved_tflops = flops / dt / 1e12
    achieved_gbs = bytes_acc / dt / 1e9
    print(f"step: {segs}x{cf} frames, {dt*1000:.1f} ms -> {fps:,.0f} "
          f"frames/s", file=sys.stderr)
    print(f"XLA cost: {flops/1e9:.2f} GFLOP/step "
          f"({flops_frame/1e6:.2f} MFLOP/frame), "
          f"{bytes_acc/1e9:.2f} GB/step ({bytes_frame/1e6:.2f} MB/frame)",
          file=sys.stderr)
    pct_f32 = 100 * achieved_tflops / peaks["f32_tflops"]
    pct_hbm = 100 * achieved_gbs / peaks["hbm_gbs"]
    print(f"achieved: {achieved_tflops:.3f} TFLOP/s ({pct_f32:.2f}% of the "
          f"f32 peak), {achieved_gbs:.1f} GB/s ({pct_hbm:.1f}% of the HBM "
          f"peak; {peaks['source']})", file=sys.stderr)
    print(json.dumps({
        "device": dev.device_kind, "segments": segs, "chunk_frames": cf,
        "frames_per_sec": round(fps, 1),
        "mflop_per_frame": round(flops_frame / 1e6, 3),
        "mbytes_per_frame": round(bytes_frame / 1e6, 3),
        "achieved_tflops": round(achieved_tflops, 4),
        "achieved_gb_per_s": round(achieved_gbs, 2),
        "pct_hbm_peak": round(pct_hbm, 2),
        "pct_f32_peak": round(pct_f32, 2),
    }))


if __name__ == "__main__":
    main()
