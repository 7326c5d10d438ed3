"""Measure the segment-parallel analyses' frame agreement with the exact
sequential analyzers on an hour-long scene.

Generates the canonical mixed scene (generators.mixed_scene: melody notes,
percussion, noise beds, silence), analyzes it twice — exact sequential
(PitchAnalyzer/OnsetAnalyzer, state carried frame to frame for the whole
recording) and segment-parallel (models/segmented.py, default auto segment
count with warmup overlap) — and prints the frame-agreement percentages.

Agreement definitions (same as tests/test_segmented.py):
* pitch: a frame agrees when its sets of stable pitch frequencies match to
  0.1 Hz;
* onset: identical onset count, every onset within 2 frames (~2.9 ms), plus
  the exact-fired-frame agreement rate.

Usage:  python tools/agreement_1h.py [--minutes 60] [--cpu] [--seed 0]

Runs on the default JAX device.  --cpu forces the host backend (use small
--minutes there: the sequential scan is slow on a CPU).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (small --minutes advised)")
    ap.add_argument("--sample-rate", type=float, default=44100.0)
    ap.add_argument("--warmup-mode", default="full",
                    choices=("full", "floor"),
                    help="segmented pitch warmup mode (the 'floor' "
                         "experiment skips the comb on most look-back "
                         "frames; this tool is its agreement gate)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from audio_analyzer_rs_tpu.models import generators as gen
    from audio_analyzer_rs_tpu.models.analyzer import (OnsetAnalyzer,
                                                       PitchAnalyzer)
    from audio_analyzer_rs_tpu.models.segmented import (
        segmented_onset_analysis, segmented_pitch_analysis)
    from audio_analyzer_rs_tpu.utils.framing import num_frames

    sr = args.sample_rate
    t0 = time.time()
    x = gen.mixed_scene(args.minutes * 60.0, sr, seed=args.seed)
    print(f"scene: {args.minutes:g} min at {sr:g} Hz "
          f"({len(x):,} samples, {time.time()-t0:.1f}s to render)",
          file=sys.stderr)

    # ── pitch ───────────────────────────────────────────────────────────
    n_p = num_frames(len(x), 2048, 512)
    t0 = time.time()
    sf, ss, sv = segmented_pitch_analysis(x, sr,
                                          warmup_mode=args.warmup_mode)
    t_seg = time.time() - t0
    t0 = time.time()
    seq = PitchAnalyzer(sr).process(x)
    t_seq = time.time() - t0
    agree = 0
    for i in range(n_p):
        a = sorted(int(round(float(f) * 10)) for f in sf[i][sv[i]])
        b = sorted(int(round(float(f) * 10)) for f in
                   seq.stable_freqs[i][seq.stable_valid[i]])
        agree += a == b
    pitch_pct = 100.0 * agree / max(n_p, 1)
    print(f"pitch: {agree:,}/{n_p:,} frames agree ({pitch_pct:.3f}%); "
          f"segmented {t_seg:.1f}s vs sequential {t_seq:.1f}s wall",
          file=sys.stderr)

    # ── onset ───────────────────────────────────────────────────────────
    n_o = num_frames(len(x), 256, 64)
    t0 = time.time()
    fired, vel, flux, energy = segmented_onset_analysis(x, sr)
    t_seg_o = time.time() - t0
    t0 = time.time()
    oseq = OnsetAnalyzer(sr).process(x)
    t_seq_o = time.time() - t0
    seq_fired = np.asarray(oseq.fired)[:n_o]
    frame_agree = int((fired == seq_fired).sum())
    seg_idx = np.flatnonzero(fired)
    seq_idx = np.flatnonzero(seq_fired)
    if len(seg_idx) == len(seq_idx) and len(seq_idx):
        max_shift = int(np.abs(seg_idx - seq_idx).max())
    else:
        max_shift = -1   # onset count mismatch
    onset_pct = 100.0 * frame_agree / max(n_o, 1)
    print(f"onset: {frame_agree:,}/{n_o:,} frames agree ({onset_pct:.4f}%); "
          f"{len(seq_idx)} sequential vs {len(seg_idx)} segmented onsets, "
          f"max shift {max_shift} frames; segmented {t_seg_o:.1f}s vs "
          f"sequential {t_seq_o:.1f}s wall", file=sys.stderr)

    print(json.dumps({
        "minutes": args.minutes, "seed": args.seed,
        "warmup_mode": args.warmup_mode,
        "pitch_frames": n_p, "pitch_agreement_pct": round(pitch_pct, 3),
        "onset_frames": n_o, "onset_agreement_pct": round(onset_pct, 4),
        "onset_count_seq": len(seq_idx), "onset_count_seg": len(seg_idx),
        "onset_max_shift_frames": max_shift,
    }))


if __name__ == "__main__":
    main()
