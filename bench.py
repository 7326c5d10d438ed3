"""Headline benchmark: pitch STFT+feature frames/sec/chip on 44.1 kHz mono.

Runs the flagship pitch pipeline (frame → Hann window × rDFT magnitude →
per-bin noise-floor scan → harmonic-comb pitch extraction → tracker scan) on
one GPU over 1 hour of synthesized 44.1 kHz mono audio, streamed in
fixed-size chunks with state carry.  STFT backend: the candidate-banded
GEMM rDFT (ops.stft.PITCH_BACKEND; see ops/fft.py).  Refuses to run
without a GPU: a CPU number is not a device number.

Baseline: the Rust reference is realtime by construction (86.13 frames/s at
window 2048 / hop 512, ref src/audio_io/stft.rs:169-171); the north star is
>=100x realtime per chip (BASELINE.json) => vs_baseline = fps / 8613.3.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device": {"platform", "kind", "count"}}.  Diagnostics (incl. the
spectral-MSE fidelity check) go to stderr.
"""

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp
    from audio_analyzer_rs_tpu.models.analyzer import pitch_analyze_frames
    from audio_analyzer_rs_tpu.ops import noisefloor, tracker
    from audio_analyzer_rs_tpu.ops.stft import stft_mags, stft_mags_np
    from audio_analyzer_rs_tpu.utils.framing import frame_signal
    from audio_analyzer_rs_tpu.models import generators as gen

    sr = 44100.0
    window, hop = 2048, 512
    chunk_frames = 1024                      # ~11.9 s of audio per step
    chunk_samples = (chunk_frames - 1) * hop + window
    total_audio_s = 3600.0                   # 1 hour
    total_frames_target = int((total_audio_s * sr - window) // hop + 1)
    n_chunks = max(total_frames_target // chunk_frames, 1)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {devices[0].platform!r}")
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    log(f"device: {device}")
    log(f"chunk: {chunk_frames} frames ({chunk_samples} samples); "
        f"{n_chunks} chunks for 1h")

    # ── fidelity gate: spectral MSE vs float64 oracle ───────────────────
    # Gate the production pitch backend (the banded rDFT's dot products are
    # the full-width GEMM's column prefix, so full-width checks the math).
    from audio_analyzer_rs_tpu.ops.stft import PITCH_BACKEND
    probe = gen.tone_with_harmonics(220.0, 1.0, sr, harmonics=8, amplitude=0.5)
    mags = np.asarray(stft_mags(probe, window, hop, backend=PITCH_BACKEND))
    oracle = stft_mags_np(probe, window, hop)
    mse = float(np.mean((mags - oracle) ** 2) / np.mean(oracle ** 2))
    log(f"spectral relative MSE vs float64 oracle ({PITCH_BACKEND}): {mse:.3e}")
    assert mse < 1e-6, f"fidelity gate failed: {mse}"

    # ── build jitted streaming step ─────────────────────────────────────
    # Lean jit boundary: return only the stable-pitch outputs (what the
    # reference worker emits, ref stft.rs:387-390) so XLA drops the [N, half]
    # magnitude/raw output buffers (they are intermediates, not products).
    @jax.jit
    def step(nf_state, tr_state, audio, gf):
        frames = frame_signal(audio, window, hop)
        nf_state, tr_state, out = pitch_analyze_frames(
            nf_state, tr_state, frames, gf,
            jnp.zeros((chunk_frames,), bool), sr)
        return nf_state, tr_state, (out.stable_freqs, out.stable_scores,
                                    out.stable_valid)

    rng = np.random.default_rng(0)
    base = gen.tone_with_harmonics(220.0, chunk_samples / sr, sr,
                                   harmonics=10, amplitude=0.4)[:chunk_samples]
    noise = (rng.standard_normal(chunk_samples) * 1e-3).astype(np.float32)
    audio = jnp.asarray(base + noise)
    gf = jnp.full((chunk_frames,), 1e-3, jnp.float32)

    nf_state = noisefloor.init_state(window // 2 + 1)
    tr_state = tracker.init_state()

    def force(x):
        return jax.block_until_ready(x)

    # Warmup / compile.
    t0 = time.perf_counter()
    nf_state, tr_state, out = step(nf_state, tr_state, audio, gf)
    force(out)
    log(f"compile+first step: {time.perf_counter() - t0:.1f}s")

    # Steady-state single stream: run the 1-hour workload (or >= 8 chunks).
    iters = max(min(n_chunks, 64), 8)
    t0 = time.perf_counter()
    for _ in range(iters):
        nf_state, tr_state, out = step(nf_state, tr_state, audio, gf)
    force(out)
    dt = time.perf_counter() - t0
    fps_single = iters * chunk_frames / dt
    log(f"single stream: {iters} chunks in {dt:.2f}s -> {fps_single:,.0f} "
        f"frames/s ({fps_single * hop / sr:,.0f}x realtime)")

    # ── segment-parallel mode (models/segmented.py): the same 1-hour file
    # split into contiguous segments analyzed in parallel with warmup
    # overlap (DEFAULT_WARMUP_FRAMES, swept in tools/warmup_sweep.py).
    # Frame agreement with the sequential run is gated by chip_smoke.py.
    # Geometry carried over from an earlier build; re-swept by ROADMAP 1.5.
    from audio_analyzer_rs_tpu.models.segmented import (
        DEFAULT_WARMUP_FRAMES, _vmapped_step, segmented_pitch_analysis)
    from audio_analyzer_rs_tpu.ops import noisefloor as nf_mod
    from audio_analyzer_rs_tpu.ops import tracker as tr_mod
    from audio_analyzer_rs_tpu.utils.framing import num_frames
    segs, seg_cf = 128, 64
    seg_samples = (seg_cf - 1) * hop + window
    seg_audio = audio[:seg_samples]

    def repl(state):
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (segs,) + a.shape), state)
    nf_b = repl(nf_mod.init_state(window // 2 + 1))
    tr_b = repl(tr_mod.init_state())
    audio_b = jnp.broadcast_to(seg_audio, (segs,) + seg_audio.shape)
    gf_b = jnp.full((segs, seg_cf), 1e-3, jnp.float32)
    on_b = jnp.zeros((segs, seg_cf), bool)
    nf_b, tr_b, outb = _vmapped_step(nf_b, tr_b, audio_b, gf_b, on_b,
                                     sr, window, hop)
    force(outb)
    # 3x the 1-hour workload per timing run, to tighten run-to-run spread.
    seg_iters = 3 * max(total_frames_target // (segs * seg_cf), 4)
    t0 = time.perf_counter()
    for _ in range(seg_iters):
        nf_b, tr_b, outb = _vmapped_step(nf_b, tr_b, audio_b, gf_b, on_b,
                                         sr, window, hop)
    force(outb)
    dt = time.perf_counter() - t0
    fps = seg_iters * segs * seg_cf / dt
    warmup_overhead = segs * DEFAULT_WARMUP_FRAMES / total_frames_target
    log(f"segment-parallel x{segs}: {seg_iters} steps in {dt:.2f}s -> "
        f"{fps:,.0f} frames/s ({fps * hop / sr:,.0f}x realtime); "
        f"full 1h incl. warmup overhead ~"
        f"{total_frames_target * (1 + warmup_overhead) / fps:.2f}s")

    # ── end-to-end (upload-inclusive): 30 min of int16 audio through the
    # public entry point with transfer="auto" — the number a user actually
    # waits for, host→device transfer included.  Content is tiled from the
    # same harmonic chunk: upload cost depends only on bytes, not signal.
    # The first run eats the compile (logged); the second is reported.
    e2e_seconds = 1800.0
    reps = int(np.ceil(e2e_seconds * sr / chunk_samples))
    host = np.tile(np.asarray(base + noise, np.float32), reps)
    host = host[:int(e2e_seconds * sr)]
    audio_i16 = np.clip(host * 32768.0, -32768, 32767).astype(np.int16)
    n_e2e = num_frames(len(audio_i16), window, hop)
    t0 = time.perf_counter()
    segmented_pitch_analysis(audio_i16, sr)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    segmented_pitch_analysis(audio_i16, sr)
    dt = time.perf_counter() - t0
    e2e_fps = n_e2e / dt
    log(f"e2e 30 min int16 (transfer=auto, upload-inclusive): "
        f"{dt:.2f}s -> {e2e_fps:,.0f} frames/s "
        f"({e2e_fps * hop / sr:,.0f}x realtime); first run {cold:.2f}s")

    baseline_fps = 100.0 * sr / hop   # north star: 100x realtime
    record = {
        "metric": "pitch_pipeline_frames_per_sec_per_chip",
        "value": round(fps, 1),
        "unit": ("frames/s (window 2048, hop 512, 44.1kHz mono; STFT+noise"
                 f"floor+pitch+tracker; {segs} parallel segments w/ "
                 f"{DEFAULT_WARMUP_FRAMES}-frame warmup; device-compute "
                 "only, synthetic repeated chunks — e2e adds host->device "
                 f"upload; single-stream {fps_single:,.0f})"),
        "vs_baseline": round(fps / baseline_fps, 2),
        "e2e_value": round(e2e_fps, 1),
        "e2e_unit": ("frames/s end-to-end incl. host->device upload (30 min "
                     "int16 mono through segmented_pitch_analysis"
                     "(transfer='auto'))"),
        "e2e_vs_baseline": round(e2e_fps / baseline_fps, 2),
        "device": device,
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
