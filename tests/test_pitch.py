"""Pitch pipeline parity: vectorized device kernels vs NumPy transcriptions
of the Rust reference (stft.rs noise floor / extract_pitches / PitchTracker),
plus end-to-end detection on synthesized tones."""

import numpy as np
import pytest

from audio_analyzer_rs_tpu.models import generators as gen
from audio_analyzer_rs_tpu.models.analyzer import PitchAnalyzer
from audio_analyzer_rs_tpu.ops import noisefloor, pitch, tracker
from audio_analyzer_rs_tpu.ops.stft import stft_mags_np

SR = 44100.0
WINDOW = 2048
HALF = WINDOW // 2 + 1
BIN_W = SR / WINDOW


# ── noise floor scan vs oracle ───────────────────────────────────────────

def test_noise_floor_scan_matches_oracle(rng):
    mags = (rng.random((40, HALF)) * 10.0).astype(np.float32)
    # Put a sustained "note" in some bins so the freeze path is exercised.
    mags[5:, 100] = 50.0
    mags[10:, 300] = 80.0
    gf = np.full(40, 0.5, np.float32)
    state = noisefloor.init_state(HALF)
    _, eff = noisefloor.noise_floor_scan(state, mags, gf)
    oracle = noisefloor.noise_floor_np(mags, gf)
    np.testing.assert_allclose(np.asarray(eff), oracle, rtol=2e-5, atol=1e-6)


def test_noise_floor_streaming_equals_batch(rng):
    mags = (rng.random((30, HALF)) * 5.0).astype(np.float32)
    gf = np.full(30, 0.2, np.float32)
    s = noisefloor.init_state(HALF)
    _, full = noisefloor.noise_floor_scan(s, mags, gf)
    s2 = noisefloor.init_state(HALF)
    parts = []
    for lo, hi in [(0, 7), (7, 8), (8, 30)]:
        s2, e = noisefloor.noise_floor_scan(s2, mags[lo:hi], gf[lo:hi])
        parts.append(np.asarray(e))
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(full),
                               rtol=1e-6)


# ── extract_pitches vs oracle ────────────────────────────────────────────

def harmonic_spectrum(f0, n_harm=10, amp=100.0, noise=0.01, rng=None):
    """Synthetic magnitude spectrum with peaked harmonics of f0."""
    mags = np.full(HALF, noise, np.float32)
    if rng is not None:
        mags += (rng.random(HALF) * noise).astype(np.float32)
    for h in range(1, n_harm + 1):
        b = f0 * h / BIN_W
        if b >= HALF - 2:
            break
        bi = int(round(b))
        # 3-bin peak shape with sub-bin offset baked into neighbor weights
        frac = b - bi
        mags[bi] += amp / h
        mags[bi - 1] += amp / h * (0.5 - 0.4 * frac)
        mags[bi + 1] += amp / h * (0.5 + 0.4 * frac)
    return mags


def _compare_frame(mags, floor):
    out = pitch.extract_pitches(mags[None], floor[None], BIN_W)
    got = [(float(f), float(s)) for f, s, v in
           zip(np.asarray(out.freqs[0]), np.asarray(out.scores[0]),
               np.asarray(out.valid[0])) if v]
    want = pitch.extract_pitches_np(mags, floor, BIN_W)
    assert len(got) == len(want), f"count mismatch: {got} vs {want}"
    for (gf_, gs), (wf, ws) in zip(got, want):
        assert abs(gf_ - wf) / max(wf, 1e-9) < 1e-4, (got, want)
        assert abs(gs - ws) / max(abs(ws), 1e-9) < 1e-3, (got, want)


def test_extract_single_tone_matches_oracle(rng):
    mags = harmonic_spectrum(220.0, rng=rng)
    floor = np.full(HALF, 0.05, np.float32)
    _compare_frame(mags, floor)


def test_extract_two_tones_matches_oracle(rng):
    mags = harmonic_spectrum(220.0, rng=rng) + harmonic_spectrum(293.66, amp=80.0)
    floor = np.full(HALF, 0.05, np.float32)
    _compare_frame(mags, floor)


def test_extract_octave_ghost_suppression(rng):
    # 220 Hz with strong even harmonics → 440 would be a ghost candidate.
    mags = harmonic_spectrum(220.0, n_harm=14, rng=rng)
    floor = np.full(HALF, 0.02, np.float32)
    _compare_frame(mags, floor)
    out = pitch.extract_pitches(mags[None], floor[None], BIN_W)
    freqs = np.asarray(out.freqs[0])[np.asarray(out.valid[0])]
    # The fundamental must be reported; 440 should be suppressed as a ghost.
    assert any(abs(f - 220.0) < 5.0 for f in freqs), freqs


def test_extract_random_spectra_match_oracle(rng):
    for trial in range(8):
        mags = (rng.random(HALF).astype(np.float32) * 10.0) ** 2
        floor = np.full(HALF, float(rng.random() * 2.0 + 0.1), np.float32)
        _compare_frame(mags, floor)


def test_extract_silence_returns_empty():
    mags = np.zeros(HALF, np.float32)
    floor = np.full(HALF, 0.1, np.float32)
    out = pitch.extract_pitches(mags[None], floor[None], BIN_W)
    assert not np.asarray(out.valid).any()
    assert pitch.extract_pitches_np(mags, floor, BIN_W) == []


# ── tracker vs oracle ────────────────────────────────────────────────────

def _run_tracker_pair(frames_raw, onsets):
    """frames_raw: list of list[(freq, score)]."""
    n = len(frames_raw)
    rf = np.zeros((n, 8), np.float32)
    rs = np.zeros((n, 8), np.float32)
    rv = np.zeros((n, 8), bool)
    for i, pitches in enumerate(frames_raw):
        for j, (f, s) in enumerate(pitches[:8]):
            rf[i, j], rs[i, j], rv[i, j] = f, s, True
    st = tracker.init_state()
    _, (sf, ss, sv) = tracker.tracker_scan(st, rf, rs, rv, np.asarray(onsets))
    got = [[(float(f), float(s)) for f, s, v in zip(np.asarray(sf[i]),
                                                    np.asarray(ss[i]),
                                                    np.asarray(sv[i])) if v]
           for i in range(n)]
    oracle = tracker.PitchTrackerNp()
    want = [oracle.process(list(frames_raw[i]), bool(onsets[i]))
            for i in range(n)]
    return got, want


def _assert_tracks_equal(got, want):
    assert len(got) == len(want)
    for g_frame, w_frame in zip(got, want):
        assert len(g_frame) == len(w_frame), (got, want)
        for (gf_, gs), (wf, ws) in zip(g_frame, w_frame):
            assert abs(gf_ - wf) < 1e-3 and abs(gs - ws) < 1e-4


def test_tracker_display_threshold_and_decay():
    frames = [[(440.0, 5.0)], [(440.0, 5.0)], [(440.0, 5.0)], [], [], [], []]
    onsets = [False] * 7
    got, want = _run_tracker_pair(frames, onsets)
    _assert_tracks_equal(got, want)
    assert got[0] == []          # 1 hit < display threshold
    assert len(got[1]) == 1      # 2 hits → displayed
    assert len(got[3]) == 1      # coasting on life
    assert got[5] == []          # decayed away


def test_tracker_ema_blend_and_onset_snap():
    # Frame 2 EMA track sits at 442*0.6+450*0.4 = 445.2; 440 is within the 3%
    # tolerance, so on an onset frame the track snaps straight to 440.
    frames = [[(440.0, 5.0)], [(445.0, 5.0)], [(450.0, 5.0)], [(440.0, 6.0)]]
    onsets = [False, False, False, True]
    got, want = _run_tracker_pair(frames, onsets)
    _assert_tracks_equal(got, want)
    # EMA: 440*0.6 + 445*0.4 = 442.0
    assert abs(got[1][0][0] - 442.0) < 1e-3
    # Onset snap: jumps straight to 440.
    assert abs(got[3][0][0] - 440.0) < 1e-3


def test_tracker_onset_reaps_unmatched():
    frames = [[(440.0, 5.0)], [(440.0, 5.0)], [(880.0, 5.0)], [(880.0, 5.0)]]
    onsets = [False, False, True, False]
    got, want = _run_tracker_pair(frames, onsets)
    _assert_tracks_equal(got, want)
    assert got[2] == []  # 440 reaped by onset; 880 only has 1 hit
    assert len(got[3]) == 1 and abs(got[3][0][0] - 880.0) < 1e-3


def test_tracker_polyphonic_random(rng):
    frames = []
    for i in range(30):
        pitches = []
        for f0 in [220.0, 330.0, 440.0, 550.0]:
            if rng.random() < 0.7:
                pitches.append((f0 * (1 + rng.normal() * 0.005),
                                float(rng.random() * 10)))
        frames.append(pitches)
    onsets = rng.random(30) < 0.1
    got, want = _run_tracker_pair(frames, list(onsets))
    _assert_tracks_equal(got, want)


# ── end-to-end pitch detection on synthesized audio ──────────────────────

def test_pitch_analyzer_detects_tone():
    x = gen.tone_with_harmonics(220.0, 1.0, SR, harmonics=8, amplitude=0.5)
    an = PitchAnalyzer(SR)
    out = an.process(x)
    assert out is not None
    # Steady state: last frames should report a stable pitch near 220.
    sf, sv = out.stable_freqs, out.stable_valid
    last = slice(len(sf) // 2, None)
    detected = sf[last][sv[last]]
    assert len(detected) > 0
    assert np.all(np.abs(detected - 220.0) < 4.0), detected


def test_pitch_analyzer_streaming_matches_batch():
    x = gen.tone_with_harmonics(330.0, 0.6, SR, harmonics=6, amplitude=0.4)
    a1 = PitchAnalyzer(SR)
    full = a1.process(x)
    a2 = PitchAnalyzer(SR)
    outs = [a2.process(c) for c in np.array_split(x, 5)]
    outs = [o for o in outs if o is not None]
    sf2 = np.concatenate([o.stable_freqs for o in outs])
    sv2 = np.concatenate([o.stable_valid for o in outs])
    assert sf2.shape == full.stable_freqs.shape
    np.testing.assert_allclose(sf2[sv2], full.stable_freqs[full.stable_valid],
                               rtol=1e-6)


def test_process_internal_chunking_is_transparent():
    """process() splits big inputs into max_chunk_frames pieces with state
    carried; with a per-row-deterministic STFT backend ("fft") outputs must
    be bit-identical to one unsplit call (the chunked path is what keeps
    hour-scale analyze_buffer within HBM).  The GEMM default (PITCH_BACKEND)
    is only tolerance-identical across chunk geometries — XLA tiles the dot
    differently per batch size, so per-row rounding shifts by ~1e-6 relative
    (see ops/stft.py PITCH_BACKEND notes)."""
    x = gen.tone_with_harmonics(220.0, 1.5, SR, harmonics=6, amplitude=0.4)
    one = PitchAnalyzer(SR, backend="fft").process(x)
    an = PitchAnalyzer(SR, backend="fft", max_chunk_frames=17)  # ragged chunks
    many = an.process(x)
    np.testing.assert_array_equal(one.stable_freqs, many.stable_freqs)
    np.testing.assert_array_equal(one.stable_valid, many.stable_valid)
    np.testing.assert_array_equal(one.raw_freqs, many.raw_freqs)
    np.testing.assert_array_equal(one.mags, many.mags)

    # Default (banded GEMM) backend: same decisions, tolerance-level values.
    one_d = PitchAnalyzer(SR).process(x)
    many_d = PitchAnalyzer(SR, max_chunk_frames=17).process(x)
    np.testing.assert_array_equal(one_d.stable_valid, many_d.stable_valid)
    np.testing.assert_allclose(one_d.stable_freqs, many_d.stable_freqs,
                               rtol=1e-5, atol=1e-3)
    # atol covers near-silent bins where the GEMM's ~1e-5 absolute rounding
    # noise dwarfs the (tiny) true magnitude.
    np.testing.assert_allclose(one_d.mags, many_d.mags, rtol=1e-4, atol=1e-4)


def test_banded_floor_seeds_above_band_state():
    """A banded scan on a fresh state must seed the above-band floor with
    the first-frame rule (not leave it zero with initialized=True), so a
    later full-width scan — attaching the debug recorder mid-stream —
    starts from plausible floors."""
    band = 464
    mags = (np.random.default_rng(3).random((20, HALF)) * 5.0 + 1.0
            ).astype(np.float32)
    gf = np.full(20, 0.5, np.float32)
    state = noisefloor.init_state(HALF)
    state, _ = noisefloor.noise_floor_scan(state, mags, gf, band)
    above = np.asarray(state.floor[band:])
    np.testing.assert_array_equal(
        above, np.maximum(mags[0, band:], gf[0] * 5.0))
    assert np.asarray(state.prev_mag[band:]).min() > 0.0


@pytest.mark.parametrize("base", ["fft", "dft"])
def test_banded_stft_backend_is_output_exact(base):
    """backend="<base>_band" computes only the candidate-band spectrum bins
    (everything the pitch pipeline reads sits below the 10 kHz cap, see
    models/analyzer.pitch_analyze_frames); stable pitch outputs must be
    bit-identical to the full-width base backend — each banded rDFT column
    is the same dot product / the same FFT bins sliced."""
    import jax.numpy as jnp
    from audio_analyzer_rs_tpu.models.analyzer import pitch_analyze_frames
    from audio_analyzer_rs_tpu.utils.framing import frame_signal

    x = gen.mixed_scene(1.2, SR, seed=11)
    frames = frame_signal(jnp.asarray(x), WINDOW, 512)
    n = frames.shape[0]
    gf = jnp.full((n,), 1e-3, jnp.float32)
    onsets = np.zeros(n, bool)
    onsets[n // 3] = True

    outs = {}
    states = {}
    for backend in (base, base + "_band"):
        nf = noisefloor.init_state(HALF)
        tr = tracker.init_state()
        nf, tr, out = pitch_analyze_frames(
            nf, tr, frames, gf, jnp.asarray(onsets), SR, backend=backend)
        outs[backend] = out
        states[backend] = (nf, tr)
    full, banded = outs[base], outs[base + "_band"]
    np.testing.assert_array_equal(np.asarray(full.stable_freqs),
                                  np.asarray(banded.stable_freqs))
    np.testing.assert_array_equal(np.asarray(full.stable_scores),
                                  np.asarray(banded.stable_scores))
    np.testing.assert_array_equal(np.asarray(full.stable_valid),
                                  np.asarray(banded.stable_valid))
    np.testing.assert_array_equal(np.asarray(full.raw_freqs),
                                  np.asarray(banded.raw_freqs))
    # The banded mags are a prefix of the full spectrum.
    band = np.asarray(banded.mags).shape[-1]
    assert band < HALF
    np.testing.assert_array_equal(np.asarray(full.mags)[:, :band],
                                  np.asarray(banded.mags))
    # Carried floor state agrees on the candidate band (above-band tail is
    # frozen in banded mode — never consumed there).
    np.testing.assert_array_equal(
        np.asarray(states[base][0].floor)[:band - 1],
        np.asarray(states[base + "_band"][0].floor)[:band - 1])


def test_comb_fminor_bit_exact_vs_xla():
    """The batched frames-minor comb (the standalone-fastest alternate,
    comb="fminor") must be bit-identical to the default per-frame vmapped
    strided-slice comb on realistic spectra — same truncation bounds, same
    chunked first-max argmax, same tail-miss mask (see
    ops/pitch._comb_fminor for when each wins)."""
    x = gen.mixed_scene(1.5, SR, seed=23)
    from audio_analyzer_rs_tpu.ops.stft import stft_mags
    mags = stft_mags(np.asarray(x), WINDOW, 512)
    n = mags.shape[0]
    floor = np.full((n, HALF), 1e-4, np.float32)
    out_x = pitch.extract_pitches(mags, floor, BIN_W, comb="xla")
    out_f = pitch.extract_pitches(mags, floor, BIN_W, comb="fminor")
    for a, b in zip(out_x, out_f):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("comb", ["pallas", "pallas_interpret"])
def test_removed_comb_backend_raises(comb):
    """The removed Pallas comb's option values raise."""
    mags = np.zeros((2, 1025), np.float32)
    with pytest.raises(ValueError, match="comb"):
        pitch.extract_pitches(mags, mags, BIN_W, comb=comb)
