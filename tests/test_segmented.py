"""Segment-parallel analysis: coverage, ordering, and agreement with the
exact sequential run."""

import numpy as np

from audio_analyzer_rs_tpu.models import generators as gen
from audio_analyzer_rs_tpu.models.analyzer import OnsetAnalyzer, PitchAnalyzer
from audio_analyzer_rs_tpu.models.segmented import (
    segmented_onset_analysis, segmented_pitch_analysis)
from audio_analyzer_rs_tpu.utils.framing import num_frames

SR = 44100.0


def melody(duration_s: float) -> np.ndarray:
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(int(SR * duration_s)) * 1e-4).astype(np.float32)
    note_len = 0.5
    freqs = [220.0, 246.94, 261.63, 293.66, 329.63, 349.23, 392.0, 440.0]
    t = 0.0
    i = 0
    while t + note_len < duration_s:
        tone = gen.tone_with_harmonics(freqs[i % len(freqs)], note_len * 0.9,
                                       SR, harmonics=6, amplitude=0.35)
        s = int(t * SR)
        x[s:s + len(tone)] += tone
        t += note_len
        i += 1
    return x


def test_segmented_matches_sequential():
    x = melody(30.0)
    n = num_frames(len(x), 2048, 512)
    sf, ss, sv = segmented_pitch_analysis(x, SR, segments=4,
                                          warmup_frames=128,
                                          chunk_frames=256)
    assert sf.shape == (n, 8)

    seq = PitchAnalyzer(SR)
    out = seq.process(x)
    assert len(out.stable_freqs) == n

    # Frame-level agreement: a frame agrees when its sets of stable pitch
    # frequencies match to 0.1 Hz.
    agree = 0
    for i in range(n):
        a = sorted(np.round(sf[i][sv[i]], 1))
        b = sorted(np.round(out.stable_freqs[i][out.stable_valid[i]], 1))
        agree += a == b
    assert agree / n > 0.99, f"only {agree}/{n} frames agree"

    # Segment 0 starts from the fresh state → bit-identical prefix.  (With
    # the GEMM pitch backend this additionally relies on XLA:CPU's dot
    # tiling being row-stable for batch sizes >= 64 — both runs' chunk
    # geometries are; see ops/stft.py PITCH_BACKEND notes.)
    first_seg = min(n, 128 + 256)
    np.testing.assert_array_equal(sf[:first_seg],
                                  out.stable_freqs[:first_seg])


def test_segmented_short_audio_single_segment():
    x = melody(3.0)
    n = num_frames(len(x), 2048, 512)
    sf, ss, sv = segmented_pitch_analysis(x, SR, segments=16,
                                          chunk_frames=256)
    assert sf.shape == (n, 8)
    seq = PitchAnalyzer(SR).process(x)
    np.testing.assert_array_equal(sf, seq.stable_freqs)


def test_segmented_empty():
    sf, ss, sv = segmented_pitch_analysis(np.zeros(100, np.float32), SR)
    assert sf.shape == (0, 8)


def percussive(duration_s: float, period_s: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(int(SR * duration_s)) * 1e-4).astype(np.float32)
    t = 0.1
    while t < duration_s - 0.1:
        burst = gen.noise_burst(0.6, 20.0, SR, seed=int(t * 1000))
        s = int(t * SR)
        x[s:s + len(burst)] += burst
        t += period_s
    return x


def test_segmented_onset_matches_sequential():
    x = percussive(20.0)
    n = num_frames(len(x), 256, 64)
    fired, vel, flux, energy = segmented_onset_analysis(
        x, SR, segments=4, warmup_frames=256, chunk_frames=1024)
    assert fired.shape == (n,)

    seq = OnsetAnalyzer(SR)
    out = seq.process(x)
    seq_fired = np.asarray(out.fired)[:n]

    seg_onsets = np.flatnonzero(fired)
    seq_onsets = np.flatnonzero(seq_fired)
    # Every sequential onset matched by a segmented one within 2 frames
    # (borderline threshold frames may shift by one near warm-started state).
    assert len(seg_onsets) == len(seq_onsets), (seg_onsets, seq_onsets)
    assert np.abs(seg_onsets - seq_onsets).max() <= 2

    # Segment 0 runs from the fresh state → bit-identical prefix.
    first_seg = min(n, 256 + 1024)
    np.testing.assert_array_equal(fired[:first_seg], seq_fired[:first_seg])
    np.testing.assert_array_equal(vel[:first_seg],
                                  np.asarray(out.velocity)[:first_seg])


def test_segmented_multichip_mesh():
    """Segment axis sharded over the 8-device virtual mesh: identical output
    to the single-device run (SPMD partitioning of the vmapped step)."""
    from audio_analyzer_rs_tpu.parallel.mesh import make_mesh

    x = melody(30.0)   # long enough that both runs settle on 8 segments
    mesh = make_mesh()
    assert mesh.size == 8
    ref = segmented_pitch_analysis(x, SR, segments=8, warmup_frames=128,
                                   chunk_frames=256)
    got = segmented_pitch_analysis(x, SR, segments=8, warmup_frames=128,
                                   chunk_frames=256, mesh=mesh)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)

    xo = percussive(20.0)
    ref_o = segmented_onset_analysis(xo, SR, segments=8, warmup_frames=256,
                                     chunk_frames=1024)
    got_o = segmented_onset_analysis(xo, SR, segments=8, warmup_frames=256,
                                     chunk_frames=1024, mesh=mesh)
    for a, b in zip(ref_o, got_o):
        np.testing.assert_array_equal(a, b)


def test_segmented_onset_empty():
    fired, vel, flux, energy = segmented_onset_analysis(
        np.zeros(100, np.float32), SR)
    assert fired.shape == (0,)


def test_int16_input_bit_identical_to_float32():
    """int16 audio uploads raw (half the bytes) and converts on device by
    1/32768 — results must be bit-identical to converting on host first."""
    x = melody(4.0)
    i16 = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    f32 = i16.astype(np.float32) / 32768.0

    a = segmented_pitch_analysis(f32, SR, segments=2)
    b = segmented_pitch_analysis(i16, SR, segments=2)
    for x_a, x_b in zip(a, b):
        np.testing.assert_array_equal(x_a, x_b)

    oa = segmented_onset_analysis(f32, SR, segments=2)
    ob = segmented_onset_analysis(i16, SR, segments=2)
    for x_a, x_b in zip(oa, ob):
        np.testing.assert_array_equal(x_a, x_b)

    import audio_analyzer_rs_tpu as aat
    ba = aat.analyze_buffer_segmented(f32, SR, segments=2)
    bb = aat.analyze_buffer_segmented(i16, SR, segments=2)
    np.testing.assert_array_equal(ba.rms, bb.rms)
    np.testing.assert_array_equal(ba.flux, bb.flux)
    np.testing.assert_array_equal(ba.stable_freqs, bb.stable_freqs)
    np.testing.assert_array_equal(ba.spectrogram, bb.spectrogram)


def test_auto_segments_pow2_snapping():
    from audio_analyzer_rs_tpu.models.segmented import auto_segments
    # Below one payload-quantum → sequential.
    assert auto_segments(1000, 256) == 1
    # 1h at pitch geometry (310k frames, warmup 256): ideal 121 → snaps up.
    assert auto_segments(310_075, 256) == 128
    # 30 min → ideal 60 → snaps up to 64; 5 min → ideal 10 → down to 8.
    assert auto_segments(155_000, 256) == 64
    assert auto_segments(25_800, 256) == 8
    # Cap respected and only pow2 values emitted.
    assert auto_segments(10_000_000, 256) == 128
    for n in range(1, 400_000, 7919):
        s = auto_segments(n, 256)
        assert s & (s - 1) == 0 and 1 <= s <= 128


def test_pipelined_transfer_matches_resident():
    """transfer="pipelined" (double-buffered per-step uploads) must produce
    identical outputs to the resident path, for f32 and raw-i16 input."""
    x = melody(20.0)
    i16 = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    for audio in (x, i16):
        ref = segmented_pitch_analysis(audio, SR, segments=4,
                                       warmup_frames=128, chunk_frames=256)
        got = segmented_pitch_analysis(audio, SR, segments=4,
                                       warmup_frames=128, chunk_frames=256,
                                       transfer="pipelined")
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)

    xo = percussive(15.0)
    ref_o = segmented_onset_analysis(xo, SR, segments=4, warmup_frames=256,
                                     chunk_frames=1024)
    got_o = segmented_onset_analysis(xo, SR, segments=4, warmup_frames=256,
                                     chunk_frames=1024, transfer="pipelined")
    for a, b in zip(ref_o, got_o):
        np.testing.assert_array_equal(a, b)


def test_pipelined_transfer_matches_resident_on_mesh():
    from audio_analyzer_rs_tpu.parallel.mesh import make_mesh
    x = melody(20.0)
    mesh = make_mesh()
    ref = segmented_pitch_analysis(x, SR, segments=8, warmup_frames=128,
                                   chunk_frames=256, mesh=mesh)
    got = segmented_pitch_analysis(x, SR, segments=8, warmup_frames=128,
                                   chunk_frames=256, mesh=mesh,
                                   transfer="pipelined")
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_floor_warmup_mode_matches_full():
    """warmup_mode="floor" (comb-free floor seeding + 32-frame tracker
    re-warmup, models/segmented._segmented_pitch_floor_warmup) must agree
    with "full" warmup frame-for-frame on a mixed scene — the in-suite
    gate for the experiment (the 1 h gate is
    tools/agreement_1h.py --warmup-mode floor)."""
    x = gen.mixed_scene(90.0, SR, seed=5)
    n = num_frames(len(x), 2048, 512)
    kw = dict(segments=8, chunk_frames=64, warmup_frames=128)
    f1, s1, v1 = segmented_pitch_analysis(x, SR, transfer="resident", **kw)
    f2, s2, v2 = segmented_pitch_analysis(x, SR, warmup_mode="floor", **kw)
    assert f2.shape == (n, 8)
    agree = sum(
        sorted(np.round(f1[i][v1[i]], 1)) == sorted(np.round(f2[i][v2[i]], 1))
        for i in range(n))
    assert agree == n, f"only {agree}/{n} frames agree"
    # Segment 0 has no look-back in either mode: exact prefix.
    first = min(n, 128 + 64)
    np.testing.assert_array_equal(f1[:first], f2[:first])


def test_floor_warmup_short_audio_falls_back():
    """Segments too short for a full look-back fall back to "full" mode
    (and a single segment has nothing to warm)."""
    x = melody(4.0)
    n = num_frames(len(x), 2048, 512)
    f1, s1, v1 = segmented_pitch_analysis(x, SR, transfer="resident")
    f2, s2, v2 = segmented_pitch_analysis(x, SR, warmup_mode="floor")
    assert f2.shape == (n, 8)
    np.testing.assert_array_equal(f1, f2)


def test_resolve_transfer_auto_policy():
    """transfer="auto" follows the e2e crossover: pipelined only for a
    standalone pitch analysis of >= AUTO_PIPELINED_MIN_SECONDS; resident
    for onsets, shared uploads, and short audio."""
    from audio_analyzer_rs_tpu.models.segmented import (
        AUTO_PIPELINED_MIN_SECONDS, _resolve_transfer)

    long_n = int(AUTO_PIPELINED_MIN_SECONDS * SR) + 1
    short_n = int(AUTO_PIPELINED_MIN_SECONDS * SR) - 1
    assert _resolve_transfer("auto", "pitch", long_n, SR, None) == "pipelined"
    assert _resolve_transfer("auto", "pitch", short_n, SR, None) == "resident"
    # Shared device upload: the bytes are already on device; never pipeline.
    assert _resolve_transfer("auto", "pitch", long_n, SR,
                             object()) == "resident"
    # Onset compute can't hide uploads; pipelined only costs rounding bytes.
    assert _resolve_transfer("auto", "onset", long_n, SR, None) == "resident"
    # Explicit modes pass through untouched.
    assert _resolve_transfer("resident", "pitch", long_n, SR,
                             None) == "resident"
    assert _resolve_transfer("pipelined", "onset", short_n, SR,
                             None) == "pipelined"
    # Typos / unknown modes raise instead of silently running resident
    # (e.g. "Auto", "pipeline").
    import pytest
    for bad in ("Auto", "pipeline", "", "stream"):
        with pytest.raises(ValueError, match="transfer="):
            _resolve_transfer(bad, "pitch", long_n, SR, None)
