"""Batched STFT: frame → Hann window → rDFT magnitude.

The reference computes one 2048-pt FFT per 512-sample hop on a worker thread
(ref src/audio_io/stft.rs:273-318) and one 256-pt FFT per 64-sample hop for
onsets (ref src/analysis/onset.rs:244-272).  Here all frames are computed in
one batched device program; XLA fuses the gather (framing) and the windowing
multiply into the DFT matmul's operand read, so the whole pipeline is a
single HBM pass per frame block.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.framing import frame_signal, num_frames
from .fft import DEFAULT_BACKEND, hann_window, rfft_mag

# Pitch-analysis geometry (ref stft.rs:169-171).
PITCH_WINDOW = 2048
PITCH_HOP = 512
# Onset-analysis geometry (ref onset.rs:122-125).
ONSET_WINDOW = 256
ONSET_HOP = 64

# Default backend for the *pitch* pipeline (models/analyzer.py,
# models/segmented.py): the candidate-banded GEMM rDFT at HIGHEST
# precision.  The pitch stages read only spectrum bins [0, kc+1) (~465 of
# 1025 — the 10 kHz candidate cap), so the banded rDFT computes exactly
# what is consumed.  The choice is carried over from an earlier build;
# against cuFFT on the H100 it is not measured yet (ROADMAP 1.4).  Both
# pass the 1e-6 spectral gate (chip_smoke.py phase 1).  Full-spectrum
# consumers (onset, feature pack, spectrogram) keep fft.DEFAULT_BACKEND.
PITCH_BACKEND = "dft_band"


@partial(jax.jit, static_argnames=("window", "hop", "backend"))
def stft_mags(x: jax.Array, window: int = PITCH_WINDOW, hop: int = PITCH_HOP,
              backend: str = DEFAULT_BACKEND) -> jax.Array:
    """[n] float32 mono → [num_frames, window//2+1] magnitude spectra."""
    frames = frame_signal(x, window, hop)
    win = jnp.asarray(hann_window(window))
    return rfft_mag(frames * win[None, :], backend=backend)


@partial(jax.jit, static_argnames=("window", "backend", "band"))
def windowed_mags(frames: jax.Array, window: int = PITCH_WINDOW,
                  backend: str = DEFAULT_BACKEND,
                  band: int | None = None) -> jax.Array:
    """[N, window] pre-framed audio → [N, window//2+1] magnitudes.

    backend: "fft" (jnp.fft — the full-spectrum default) or "dft" (a
    matmul via XLA — with `band`, the pitch-pipeline default; see
    PITCH_BACKEND).  Any other value raises ValueError.

    `band` (static): compute/return only the first `band` bins (see
    ops.fft.rfft_mag) — output [N, band].
    """
    win = jnp.asarray(hann_window(window))
    return rfft_mag(frames * win[None, :], backend=backend, band=band)


def stft_mags_np(x: np.ndarray, window: int = PITCH_WINDOW,
                 hop: int = PITCH_HOP) -> np.ndarray:
    """Float64 NumPy oracle of `stft_mags` (reference-transcribed semantics)."""
    n = num_frames(len(x), window, hop)
    win = hann_window(window).astype(np.float64)
    out = np.empty((n, window // 2 + 1), dtype=np.float64)
    for i in range(n):
        seg = x[i * hop:i * hop + window].astype(np.float64) * win
        out[i] = np.abs(np.fft.rfft(seg))
    return out
