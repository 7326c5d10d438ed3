"""Bring-up check on an NVIDIA GPU: the engine's main paths, end to end.

    python chip_smoke.py              # phases 0-5 on one card
    python chip_smoke.py --chips 4    # only the data-parallel layers, 4 cards

One process drives the card.  Each phase prints one line with its results,
its wall time and the device's `peak_bytes_in_use`; any failure raises and
the script exits non-zero.  The last line of standard output is the JSON
contract `{"ok": true, "device": {"platform", "kind", "count"}}`.

Phases (one card):
  0  the device, the card's name and power limit, the native runtime
     rebuilt from source and loaded by the engine;
  1  kernels and numerics at real widths: the STFT spectral gate for the
     banded GEMM rDFT and for cuFFT, the tracker kernel against the XLA
     scan and the NumPy tracker, and the card-only tests (marker `gpu`);
  2  an hour of int16 audio through `analyze_buffer_segmented`, checked
     against the exact sequential analyzers on the first five minutes;
  3  a classroom: an `EnginePool` of 16 live engines, two checked against
     solo twins;
  4  a homework batch of 64 takes against each take's own run;
  5  the JSON-RPC surface, in process.

`--chips 4` runs only `__graft_entry__.multichip_layers` on a real 4-card
mesh, with the tolerances of phases 2 and 3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

STFT_REL_MSE_MAX = 1e-6       # the spectral gate of bench.py
# Stable-pitch frame agreement with the exact sequential run.  Segments
# warm their state on look-back frames, and the GEMM may tile differently
# for another chunk geometry, so a borderline peak can flip a frame.
PITCH_AGREEMENT_MIN = 0.9999
# Polled JSON floats (tuner cents and frequencies, onset velocities) of a
# pooled engine against its solo twin.  The pool's batched rDFT GEMM tiles
# differently from the solo one on the GPU, so spectra differ in the last
# bits, and the parabolic peak interpolation carries that into tracked
# frequencies: 0.014 cents on a tuner reading was observed on the H100.
# 0.05 (cents, Hz, velocity) is far below what a player can hear; labels,
# note names, counts and sample offsets must still match exactly.
JSON_RTOL, JSON_ATOL = 1e-4, 0.05
TRACKER_SEGMENTS, TRACKER_FRAMES = 128, 64
CLASSROOM_K, CLASSROOM_SR, CLASSROOM_BUFFER = 16, 48000.0, 1024
BATCH_TAKES, BATCH_MIN_S, BATCH_MAX_S = 64, 5.0, 120.0


# ── helpers (no JAX at import) ───────────────────────────────────────────

def card_info() -> str:
    """`name, power.limit` of each card, read by a child that never
    imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(devices, count: int) -> None:
    """Refuse anything but `count` GPUs: nothing falls back to the CPU."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke needs an NVIDIA GPU; JAX found "
                         f"{platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs; JAX found "
                         f"{len(devices)}")


def compile_cache_dir() -> str:
    from audio_analyzer_rs_tpu.compile_cache import cache_dir
    return cache_dir()


def last_line(devices) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def json_close(a, b, path="$") -> list:
    """Differences between two polled JSON values: floats within
    JSON_RTOL/JSON_ATOL, everything else equal."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys {sorted(a)} != {sorted(b)}"]
        return [d for k in a for d in json_close(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in json_close(x, y, f"{path}[{i}]")]
    if (isinstance(a, float) or isinstance(b, float)) and not (
            isinstance(a, bool) or isinstance(b, bool)):
        if abs(a - b) <= JSON_ATOL + JSON_RTOL * abs(b):
            return []
        return [f"{path}: {a!r} != {b!r}"]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def stable_agreement(sf_a, sv_a, sf_b, sv_b, hz: float = 0.1) -> float:
    """Share of frames whose sets of stable pitches match: the same number
    of pitches, each within `hz` of its partner in sorted order.  (Rounding
    to a 0.1 Hz grid instead would count two values a few mHz apart that
    straddle a grid line as a disagreement.)"""
    import numpy as np
    n = len(sv_a)
    if n == 0:
        return 1.0
    agree = 0
    for i in range(n):
        a = np.sort(sf_a[i][sv_a[i]])
        b = np.sort(sf_b[i][sv_b[i]])
        agree += len(a) == len(b) and bool(np.all(np.abs(a - b) <= hz))
    return agree / n


def _peak_bytes() -> int:
    import jax
    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def run_phase(name: str, fn) -> dict:
    t0 = time.perf_counter()
    res = fn()
    res["wall_s"] = time.perf_counter() - t0
    res["peak_bytes_in_use"] = _peak_bytes()
    print(f"phase {name}: {json.dumps(res)}", flush=True)
    return res


# ── phase 0: the device ──────────────────────────────────────────────────

def phase_device(card: str, count: int) -> dict:
    import jax
    devices = jax.devices()
    require_gpu(devices, count)
    from audio_analyzer_rs_tpu import runtime
    from audio_analyzer_rs_tpu.api.engine import AudioEngine
    engine = AudioEngine()
    if engine.native_reducer is None or not runtime.available():
        raise RuntimeError("the engine fell back to the NumPy HostReducer: "
                           "the native runtime did not load")
    return {"card": card, "kind": devices[0].device_kind,
            "count": len(devices), "jax": jax.__version__,
            "compile_cache": compile_cache_dir(), "native_reducer": True}


# ── phase 1: kernels and numerics ────────────────────────────────────────

def _random_raws(rng, s, n):
    """Raw pitches with frame-to-frame continuity, so tracks form, match,
    coast and die; ~2.5 valid per frame, ~5% onset frames."""
    import numpy as np
    from audio_analyzer_rs_tpu.ops.pitch import MAX_NOTES
    n_valid = rng.integers(0, 6, size=(s, n))
    valid = np.arange(MAX_NOTES)[None, None, :] < n_valid[..., None]
    base = rng.uniform(80.0, 900.0, size=(s, 1, MAX_NOTES))
    drift = np.cumsum(rng.normal(0, 0.004, (s, n, MAX_NOTES)), axis=1)
    jump = rng.random((s, n, MAX_NOTES)) < 0.05
    freqs = np.where(jump, rng.uniform(80.0, 900.0, (s, n, MAX_NOTES)),
                     base * np.exp(drift)).astype(np.float32)
    scores = rng.uniform(0.1, 4.0, (s, n, MAX_NOTES)).astype(np.float32)
    return freqs, scores, valid, rng.random((s, n)) < 0.05


def _ulps(a, b) -> int:
    import numpy as np
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def phase_kernels() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pytest
    from audio_analyzer_rs_tpu.models import generators as gen
    from audio_analyzer_rs_tpu.ops import tracker
    from audio_analyzer_rs_tpu.ops.stft import (PITCH_BACKEND, stft_mags,
                                                stft_mags_np)
    res = {}
    sr = 44100.0
    probe = gen.tone_with_harmonics(220.0, 2.0, sr, harmonics=8,
                                    amplitude=0.5)
    oracle = stft_mags_np(probe, 2048, 512)
    for backend in (PITCH_BACKEND, "fft"):
        mags = np.asarray(stft_mags(probe, 2048, 512, backend=backend))
        mse = float(np.mean((mags - oracle) ** 2) / np.mean(oracle ** 2))
        res[f"stft_rel_mse_{backend}"] = mse
        if not mse < STFT_REL_MSE_MAX:
            raise AssertionError(f"STFT gate failed for {backend}: {mse}")

    s, n = TRACKER_SEGMENTS, TRACKER_FRAMES
    rf, rs, rv, on = _random_raws(np.random.default_rng(5), s, n)
    st0 = jax.tree.map(lambda a: jnp.broadcast_to(a, (s,) + a.shape),
                       tracker.init_state())
    args = (st0, jnp.asarray(rf), jnp.asarray(rs), jnp.asarray(rv),
            jnp.asarray(on))
    st_k, out_k = jax.tree.map(np.asarray, tracker.tracker_scan_batched(
        *args, impl="pallas"))
    st_x, out_x = jax.tree.map(np.asarray, tracker.tracker_scan_batched(
        *args, impl="xla"))
    for name in ("score", "life", "valid", "seq", "next_seq"):
        np.testing.assert_array_equal(getattr(st_k, name),
                                      getattr(st_x, name), err_msg=name)
    np.testing.assert_array_equal(out_k[2], out_x[2])
    np.testing.assert_array_equal(out_k[1], out_x[1])
    ulps = max(_ulps(out_k[0], out_x[0]), _ulps(st_k.freq, st_x.freq))
    if ulps > 1:
        raise AssertionError(f"tracker kernel frequencies {ulps} ulps off")
    res["tracker_vs_xla"] = ("bitwise" if ulps == 0 else
                             "ints exact, freqs within 1 ulp")
    # The NumPy transcription of the reference tracker, stream by stream.
    mismatches = 0
    for si in range(s):
        oracle_tr = tracker.PitchTrackerNp()
        for i in range(n):
            raws = [(float(rf[si, i, j]), float(rs[si, i, j]))
                    for j in range(rf.shape[-1]) if rv[si, i, j]]
            want = oracle_tr.process(raws, bool(on[si, i]))[:8]
            got_v = out_k[2][si, i]
            got = list(zip(out_k[0][si, i][got_v], out_k[1][si, i][got_v]))
            mismatches += len(got) != len(want) or any(
                abs(gf - wf) > 1e-3 or abs(gs - ws) > 1e-4
                for (gf, gs), (wf, ws) in zip(got, want))
    if mismatches:
        raise AssertionError(f"tracker kernel vs PitchTrackerNp: "
                             f"{mismatches} frames differ")
    res["tracker_vs_numpy_frames"] = s * n

    counts = {"passed": 0, "failed": 0, "skipped": 0}

    class _Count:
        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                counts[report.outcome] += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")],
                     plugins=[_Count()])
    if rc != 0 or counts["passed"] == 0 or counts["skipped"]:
        raise AssertionError(f"card-only tests: rc={rc} {counts}")
    res["card_only_tests"] = counts
    return res


# ── phase 2: one hour of audio ───────────────────────────────────────────

def _sequential(analyzer, audio, chunk_frames: int, chunks: int):
    """Feed the exact sequential analyzer whole chunks of `chunk_frames`
    frames — its `max_chunk_frames` — so every device call has one shape
    and compiles once."""
    w, hop = analyzer.window, analyzer.hop
    ends = [(chunk_frames * (k + 1) - 1) * hop + w for k in range(chunks)]
    outs, start = [], 0
    for end in ends:
        outs.append(analyzer.process(audio[start:end]))
        start = end
    return outs


def phase_bulk(seconds: float = 3600.0, check_seconds: float = 300.0
               ) -> dict:
    import numpy as np
    from audio_analyzer_rs_tpu.analysis import analyze_buffer_segmented
    from audio_analyzer_rs_tpu.models import generators as gen
    from audio_analyzer_rs_tpu.models.analyzer import (OnsetAnalyzer,
                                                       PitchAnalyzer)
    from audio_analyzer_rs_tpu.utils.framing import num_frames
    sr = 44100.0
    res = {"audio_s": seconds}
    t0 = time.perf_counter()
    scene = gen.mixed_scene(seconds, sr, seed=0)
    audio = np.clip(np.round(scene * 32767.0), -32768, 32767).astype(
        np.int16)
    res["samples"] = len(audio)
    res["render_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr = analyze_buffer_segmented(audio, sr)
    res["analyze_s"] = time.perf_counter() - t0
    n = num_frames(len(audio), 2048, 512)
    res["pitch_frames"] = n
    assert arr.stable_freqs.shape == (n, 8), arr.stable_freqs.shape
    assert arr.spectrogram.shape == (n, 1025), arr.spectrogram.shape
    for col in (arr.rms, arr.centroid_hz, arr.flux, arr.yin_f0_hz,
                arr.stable_freqs):
        assert len(col) == n and np.isfinite(col).all()

    # The exact sequential analyzers on at least the first check_seconds:
    # every frame whose window lies inside the prefix sees exactly the
    # samples the hour's analysis saw (int16 / 32768, as on the device).
    prefix = audio.astype(np.float32) / 32768.0
    t0 = time.perf_counter()
    pa = PitchAnalyzer(sr)
    per = pa.max_chunk_frames
    outs = _sequential(pa, prefix, per, -(-int(check_seconds * sr / 512)
                                          // per))
    sf = np.concatenate([o.stable_freqs for o in outs])
    sv = np.concatenate([o.stable_valid for o in outs])
    res["sequential_pitch_s"] = time.perf_counter() - t0
    agree = stable_agreement(arr.stable_freqs[:len(sv)],
                             arr.stable_valid[:len(sv)], sf, sv)
    res["checked_pitch_frames"] = len(sv)
    res["stable_pitch_agreement"] = agree
    if agree < PITCH_AGREEMENT_MIN:
        raise AssertionError(f"stable-pitch agreement {agree:.6%}")
    t0 = time.perf_counter()
    oa = OnsetAnalyzer(sr)
    per = oa.max_chunk_frames
    outs = _sequential(oa, prefix, per, -(-int(check_seconds * sr / 64)
                                          // per))
    fired = np.concatenate([np.asarray(o.fired) for o in outs])
    res["sequential_onset_s"] = time.perf_counter() - t0
    n_o = len(fired)
    seq_onsets = set(np.flatnonzero(fired).tolist())
    seg_onsets = {e["frame"] for e in arr.onsets if e["frame"] < n_o}
    if seq_onsets != seg_onsets:
        raise AssertionError(f"onsets differ: {len(seq_onsets)} sequential "
                             f"vs {len(seg_onsets)} segmented, symmetric "
                             f"difference {sorted(seq_onsets ^ seg_onsets)[:10]}")
    res["checked_onset_frames"] = n_o
    res["onsets_checked"] = len(seq_onsets)
    res["onsets_total"] = len(arr.onsets)
    return res


# ── phase 3: the classroom ───────────────────────────────────────────────

def _classroom_engine(seed: int, seconds: float):
    from audio_analyzer_rs_tpu.api.device import ArraySource
    from audio_analyzer_rs_tpu.api.engine import AudioEngine
    from audio_analyzer_rs_tpu.models import generators as gen
    scene = gen.mixed_scene(seconds + 0.5, CLASSROOM_SR, seed=seed)
    e = AudioEngine(input_source=ArraySource(scene),
                    sample_rate=CLASSROOM_SR, buffer_size=CLASSROOM_BUFFER,
                    loopback_latency_samples=2048, loopback_gain=1.0)
    return e, e.start_tuner(), e.start_onset_detection()


def phase_classroom(k: int = CLASSROOM_K, steps_s: float = 10.0,
                    paced_s: float = 5.0, twins=(0, 7)) -> dict:
    from audio_analyzer_rs_tpu.api.pool import EnginePool
    total = steps_s + paced_s
    members = [_classroom_engine(100 + i, total) for i in range(k)]
    pool = EnginePool([e for e, _, _ in members], pipeline_depth=1,
                      aggregate_slots=2)
    t0 = time.perf_counter()
    pool.prepare()
    prepare_s = time.perf_counter() - t0
    pool.advance(steps_s)
    t0 = time.perf_counter()
    pool.run_realtime(paced_s)
    paced_ratio = (time.perf_counter() - t0) / paced_s
    pool.flush()
    for i in twins:
        solo, solo_tuner, solo_onset = _classroom_engine(100 + i, total)
        solo.advance(steps_s)
        solo.advance(paced_s)
        solo.flush_analysis()
        _, tuner, onset = members[i]
        diffs = json_close(json.loads(onset.poll_onsets()),
                           json.loads(solo_onset.poll_onsets()), "onsets")
        diffs += json_close(json.loads(tuner.poll_output()),
                            json.loads(solo_tuner.poll_output()), "tuner")
        if diffs:
            raise AssertionError(f"member {i} vs solo twin: {diffs[:5]}")
    return {"k": k, "prepare_s": prepare_s, "advanced_s": steps_s,
            "paced_s": paced_s, "paced_wall_over_virtual": paced_ratio,
            "waves": pool.waves, "twins_checked": list(twins)}


# ── phase 4: the homework batch ──────────────────────────────────────────

def phase_batch(n_takes: int = BATCH_TAKES) -> dict:
    import numpy as np
    from audio_analyzer_rs_tpu.models import generators as gen
    from audio_analyzer_rs_tpu.models.segmented import (
        DEFAULT_WARMUP_FRAMES, _batch_plan, segmented_pitch_analysis,
        segmented_pitch_analysis_batch)
    from audio_analyzer_rs_tpu.utils.framing import num_frames
    sr = 44100.0
    rng = np.random.default_rng(4)
    lengths = rng.uniform(BATCH_MIN_S, BATCH_MAX_S, n_takes)
    takes = [np.clip(np.round(gen.mixed_scene(float(t), sr, seed=1000 + i)
                              * 32767.0), -32768, 32767).astype(np.int16)
             for i, t in enumerate(lengths)]
    t0 = time.perf_counter()
    batch = segmented_pitch_analysis_batch(takes, sr)
    batch_s = time.perf_counter() - t0
    # Each take's own run at the batch's geometry: the take zero-padded to
    # the longest take (as the batch pads it) with the batch's segment
    # count, so both place every segment boundary and look-back warmup at
    # the same frames.  What is left to differ is the batching itself —
    # rows of other takes, and a GEMM tiled for 128 rows.  (How segment
    # geometry moves results is phase 2's check, against the sequential
    # run.)  Phase 2's tolerance applies to the batch's frames as a whole;
    # the worst single take is reported beside it.
    segments = _batch_plan([num_frames(len(t), 2048, 512) for t in takes],
                           None, DEFAULT_WARMUP_FRAMES, 64, 2048, 512
                           ).segments
    longest = max(len(t) for t in takes)
    agree, frames, worst = 0.0, 0, 1.0
    t0 = time.perf_counter()
    for i, take in enumerate(takes):
        sf, _, sv = segmented_pitch_analysis(
            np.pad(take, (0, longest - len(take))), sr, segments=segments)
        bf, _, bv = batch[i]
        sf, sv = sf[:len(bf)], sv[:len(bv)]
        take_agree = stable_agreement(bf, bv, sf, sv)
        agree += take_agree * len(sv)
        frames += len(sv)
        worst = min(worst, take_agree)
    own_s = time.perf_counter() - t0
    agree /= frames
    if agree < PITCH_AGREEMENT_MIN:
        raise AssertionError(f"the batch agrees with the takes' own runs "
                             f"on only {agree:.6%} of frames")
    return {"takes": n_takes, "audio_s": float(lengths.sum()),
            "segments_per_take": segments, "frames": frames,
            "batch_s": batch_s, "own_runs_s": own_s,
            "stable_pitch_agreement": agree,
            "worst_take_agreement": worst}


# ── phase 5: the RPC surface ─────────────────────────────────────────────

def phase_rpc() -> dict:
    import base64
    import numpy as np
    from audio_analyzer_rs_tpu.api.rpc import RpcServer
    from audio_analyzer_rs_tpu.models import generators as gen
    server = RpcServer()

    def call(method, *params, session=None):
        req = {"id": 1, "method": method, "params": list(params)}
        if session is not None:
            req["session"] = session
        resp = server.handle(req)
        if "error" in resp:
            raise AssertionError(f"{method}: {resp['error']}")
        return resp["result"]

    sr = CLASSROOM_SR
    sid = call("session.create", {"sample_rate": sr,
                                  "buffer_size": CLASSROOM_BUFFER})
    call("start_tuner", session=sid)
    call("start_onset_detection", session=sid)
    tone = gen.tone_with_harmonics(220.0, 3.0, sr, harmonics=6,
                                   amplitude=0.3)
    clicks = np.zeros_like(tone)
    for t in (0.5, 1.5, 2.5):
        burst = gen.noise_burst(0.8, 30.0, sr)
        i = int(t * sr)
        clicks[i:i + len(burst)] += burst[:len(clicks) - i]
    audio = (tone + clicks).astype("<f4")
    onsets = []
    for part in np.array_split(audio, 6):
        call("push_audio", base64.b64encode(part.tobytes()).decode(),
             session=sid)
        call("advance", len(part) / sr, session=sid)
        onsets.extend(call("poll_onsets", session=sid))
    tuner = call("poll_output", session=sid)
    if "A3" not in tuner["notes"]:
        raise AssertionError(f"tuner on a 220 Hz tone: {tuner}")
    if not onsets:
        raise AssertionError("no onsets polled over three bursts")
    return {"session": sid, "tuner_notes": tuner["notes"],
            "onsets": len(onsets)}


# ── --chips 4: the data-parallel layers ──────────────────────────────────

# Device state leaves (noise-floor IIRs ~1e-4, tracker and onset state) of
# the sharded pool against the single-device one: each card runs its own
# slice of the batch, so the GEMM tiles differently and the IIRs carry the
# last-bit differences; 1e-3 relative bounds that, and any flipped flag or
# count (a difference of 1) still fails.
STATE_RTOL, STATE_ATOL = 1e-3, 1e-6


def _multichip_check(name, got, want):
    """Tolerances of phases 2 and 3 in place of the CPU mesh's bitwise
    asserts: pitch triples by stable-frame agreement, the pool's packed
    readback by the polled-JSON tolerance, its states by STATE_RTOL."""
    import numpy as np
    got, want = list(got), list(want)
    if len(got) == 3 and np.asarray(got[2]).dtype == bool:
        agree = stable_agreement(np.asarray(got[0]), np.asarray(got[2]),
                                 np.asarray(want[0]), np.asarray(want[2]))
        if agree < PITCH_AGREEMENT_MIN:
            raise AssertionError(f"{name}: agreement {agree:.6%}")
        return
    rtol, atol = ((STATE_RTOL, STATE_ATOL) if name == "pool states"
                  else (JSON_RTOL, JSON_ATOL))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64),
                                   rtol=rtol, atol=atol, err_msg=name)


def phase_multichip(count: int) -> dict:
    import jax
    sys.path.insert(0, ROOT)
    import __graft_entry__
    summary = __graft_entry__.multichip_layers(jax.devices()[:count],
                                               _multichip_check)
    return {"devices": count, "layers": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import audio_analyzer_rs_tpu  # noqa: F401  (fails outside the repo)

    card = card_info()
    print(f"card: {card}", flush=True)
    # Rebuild the native runtime from the committed sources before anything
    # loads it: a library built on another machine may not run on this CPU.
    subprocess.run(["make", "-C", os.path.join(ROOT, "runtime"), "clean",
                    "all"], check=True, capture_output=True, timeout=600)
    from audio_analyzer_rs_tpu.compile_cache import configure_compile_cache
    configure_compile_cache()
    import jax
    run_phase("0 device", lambda: phase_device(card, args.chips))
    if args.chips == 4:
        run_phase("multichip", lambda: phase_multichip(4))
    else:
        run_phase("1 kernels", phase_kernels)
        run_phase("2 bulk hour", phase_bulk)
        run_phase("3 classroom", phase_classroom)
        run_phase("4 batch", phase_batch)
        run_phase("5 rpc", phase_rpc)
    print(last_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
