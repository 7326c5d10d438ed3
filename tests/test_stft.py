"""STFT + feature-pack fidelity tests.

Covers BASELINE configs #1-#3: 440 Hz sine → 1024-pt Hann FFT magnitude
(with WAV round-trip), full spectrogram of a 44.1 kHz mono buffer at
hop=512, and the per-frame feature pack.  Spectral MSE vs a float64 oracle
must be < 1e-6 (the north-star fidelity bound).
"""

import os

import numpy as np
import pytest

from audio_analyzer_rs_tpu.models import generators as gen
from audio_analyzer_rs_tpu.ops.features import feature_pack, feature_pack_np
from audio_analyzer_rs_tpu.ops.fft import hann_window, rfft_mag, rfft_mag_np
from audio_analyzer_rs_tpu.ops.stft import stft_mags, stft_mags_np
from audio_analyzer_rs_tpu.utils.framing import (frame_signal, frame_signal_np,
                                                 num_frames)
from audio_analyzer_rs_tpu.utils import wav

SR = 44100.0


def spectral_mse(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    # Normalized (relative) MSE so the bound is scale-free.
    return np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30)


def test_hann_window_matches_reference_formula():
    w = hann_window(2048)
    i = np.arange(2048, dtype=np.float32)
    expected = 0.5 - 0.5 * np.cos(2 * np.pi * i / 2048)
    np.testing.assert_allclose(w, expected, atol=1e-6)
    assert w.dtype == np.float32
    assert w[0] == 0.0  # periodic window starts at 0


def test_framing_matches_ring_buffer_semantics():
    x = np.arange(5000, dtype=np.float32)
    for window, hop in [(2048, 512), (256, 64), (1024, 1024)]:
        frames = np.asarray(frame_signal(x, window, hop))
        oracle = frame_signal_np(x, window, hop)
        assert frames.shape == oracle.shape
        np.testing.assert_array_equal(frames, oracle)
        assert frames.shape[0] == num_frames(5000, window, hop)


@pytest.mark.parametrize("backend", ["dft", "fft"])
def test_sine_1024pt_spectrum_config1(backend, tmp_path):
    """BASELINE config #1: 440 Hz sine → 1024-pt Hann FFT + WAV roundtrip."""
    x = gen.sine(440.0, 0.5, SR, amplitude=0.5)

    # WAV round-trip through the recorder's 16-bit quantization.
    path = os.path.join(tmp_path, "test_output.wav")
    wav.write_wav(path, x, int(SR))
    x_rt, sr_rt, ch = wav.read_wav(path)
    assert sr_rt == int(SR) and ch == 1
    assert np.max(np.abs(x_rt - x)) < 2.0 / 32768.0  # quantization bound

    window = 1024
    frames = frame_signal_np(x_rt, window, window)
    win = hann_window(window)
    mags = np.asarray(rfft_mag(frames * win, backend=backend))
    oracle = rfft_mag_np(frames * win.astype(np.float64))
    assert spectral_mse(mags, oracle) < 1e-6

    # Peak lands on the 440 Hz bin.
    peak_bin = int(np.argmax(mags[1]))
    assert abs(peak_bin * SR / window - 440.0) < SR / window


@pytest.mark.parametrize("backend", ["dft", "fft"])
def test_full_spectrogram_config2(backend):
    """BASELINE config #2: full STFT spectrogram, hop=512, window=2048."""
    rng = np.random.default_rng(42)
    x = (gen.tone_with_harmonics(220.0, 1.0, SR)
         + 0.01 * rng.standard_normal(int(SR)).astype(np.float32))
    mags = np.asarray(stft_mags(x, 2048, 512, backend=backend))
    oracle = stft_mags_np(x, 2048, 512)
    assert mags.shape == oracle.shape
    assert mags.shape[1] == 1025
    mse = spectral_mse(mags, oracle)
    assert mse < 1e-6, f"spectral MSE {mse} vs float64 oracle"


def test_onset_geometry_spectrogram():
    x = gen.sine(1000.0, 0.1, 48000.0)
    mags = np.asarray(stft_mags(x, 256, 64))
    oracle = stft_mags_np(x, 256, 64)
    assert mags.shape[1] == 129
    assert spectral_mse(mags, oracle) < 1e-6


def test_feature_pack_config3():
    """BASELINE config #3: RMS, centroid, rolloff, flux over STFT frames."""
    x = gen.sweep(200.0, 2000.0, 1.0, SR, amplitude=0.5)
    frames = frame_signal_np(x, 2048, 512)
    win = hann_window(2048)
    mags = np.asarray(rfft_mag(frames * win))
    feats = feature_pack(frames, mags, SR, 2048)
    o_rms, o_energy, o_centroid, o_rolloff, o_flux = feature_pack_np(
        frames, np.asarray(mags, dtype=np.float64), SR, 2048)

    np.testing.assert_allclose(np.asarray(feats.rms), o_rms, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(feats.energy), o_energy, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(feats.centroid_hz), o_centroid, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(feats.rolloff_hz), o_rolloff, atol=1e-3)
    np.testing.assert_allclose(np.asarray(feats.flux), o_flux, rtol=1e-4)

    # Sweep sanity: centroid should increase over time.
    c = np.asarray(feats.centroid_hz)
    assert c[-2] > c[1]


def test_lcg_noise_matches_reference_recurrence():
    out = gen.lcg_noise(16, seed=12345)
    s = 12345
    for i in range(16):
        s = (s * 1103515245 + 12345) & 0x7FFFFFFF
        expected = np.float32(s) / np.float32(2147483648.0) - np.float32(1.0)
        assert out[i] == expected


def test_downmix_and_quantize():
    stereo = np.array([1.0, 0.0, 0.5, 0.5, -1.0, 1.0], dtype=np.float32)
    mono = wav.downmix_mono(stereo, 2)
    np.testing.assert_allclose(mono, [0.5, 0.5, 0.0])
    q = wav.quantize_i16(np.array([2.0, -2.0, 0.0], dtype=np.float32))
    assert q[0] == 32767 and q[1] == -32767 and q[2] == 0


@pytest.mark.parametrize("backend", ["pallas", "mxu", "dft_bands"])
def test_unknown_stft_backend_raises(backend):
    """A removed or misspelt backend raises instead of routing anywhere."""
    x = np.zeros(4096, np.float32)
    with pytest.raises(ValueError, match="backend"):
        stft_mags(x, 2048, 512, backend=backend)
