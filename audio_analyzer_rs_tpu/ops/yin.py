"""YIN / autocorrelation monophonic pitch detection, batched.

BASELINE config #4 ("Pitch detection (autocorrelation/YIN) on generated
sweeps and recorded notes").  The reference detects pitch via harmonic-comb
STFT scoring (ops/pitch.py); YIN is the time-domain alternative the BASELINE
config list mandates.  All steps are batched tensor ops: the difference
function comes from an FFT autocorrelation (one rfft/irfft per
frame batch), the cumulative-mean normalization is a cumsum, and the
threshold search is a masked argmax — no data-dependent loops.

Reference: de Cheveigné & Kawahara (2002), "YIN, a fundamental frequency
estimator for speech and music".
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_THRESHOLD = 0.1


class YinResult(NamedTuple):
    f0_hz: jax.Array        # [N] estimated fundamental (0 where unvoiced)
    confidence: jax.Array   # [N] 1 - cmndf at the chosen lag
    voiced: jax.Array       # [N] bool


@partial(jax.jit, static_argnames=("sample_rate", "fmin", "fmax", "threshold"))
def yin_pitch(frames: jax.Array, sample_rate: float, fmin: float = 60.0,
              fmax: float = 2000.0, threshold: float = DEFAULT_THRESHOLD
              ) -> YinResult:
    """frames [N, W] float32 → per-frame f0 via YIN with CMNDF threshold."""
    n, w = frames.shape
    half = w // 2
    tau_min = max(int(sample_rate / fmax), 1)
    tau_max = min(int(sample_rate / fmin) + 1, half - 1)

    x = frames.astype(jnp.float32)
    pad = jnp.concatenate([x, jnp.zeros_like(x)], axis=-1)
    spec = jnp.fft.rfft(pad, axis=-1)

    # Difference function over the half-window integration range, computed
    # exactly: d[tau] = sum_{j<half} (x_j - x_{j+tau})^2
    #                 = E0 + E_tau - 2 * r_half[tau]
    # with E_tau from a sliding cumsum and r_half the exact cross-correlation
    # of the first half-window against the full frame (FFT-based).
    cs = jnp.cumsum(x ** 2, axis=-1)
    cs = jnp.concatenate([jnp.zeros((n, 1), jnp.float32), cs], axis=-1)
    taus = jnp.arange(half)
    e0 = cs[:, half][:, None] - cs[:, 0][:, None]          # [N, 1]
    e_tau = cs[:, taus + half] - cs[:, taus]               # [N, half]
    # Half-window autocorrelation via FFT of the first half vs full signal:
    spec_half = jnp.fft.rfft(
        jnp.concatenate([x[:, :half], jnp.zeros((n, w + w - half), jnp.float32)],
                        axis=-1), axis=-1)
    r_half = jnp.fft.irfft(jnp.conj(spec_half) * spec, axis=-1)[:, :half].real
    d = e0 + e_tau - 2.0 * r_half
    d = jnp.maximum(d, 0.0)

    # CMNDF.
    cum = jnp.cumsum(d[:, 1:], axis=-1)
    tau_idx = jnp.arange(1, half, dtype=jnp.float32)
    cmndf = jnp.concatenate(
        [jnp.ones((n, 1), jnp.float32),
         d[:, 1:] * tau_idx[None, :] / jnp.maximum(cum, 1e-12)], axis=-1)

    # First tau in [tau_min, tau_max] below threshold that is a local min.
    in_range = (taus >= tau_min) & (taus <= tau_max)
    next_c = jnp.concatenate([cmndf[:, 1:], cmndf[:, -1:]], axis=-1)
    below = in_range[None, :] & (cmndf < threshold) & (next_c >= cmndf)
    any_below = jnp.any(below, axis=-1)
    first_below = jnp.argmax(below, axis=-1)
    masked = jnp.where(in_range[None, :], cmndf, jnp.inf)
    global_min = jnp.argmin(masked, axis=-1)
    tau_star = jnp.where(any_below, first_below, global_min)

    # Parabolic interpolation on cmndf around tau_star.
    t0 = jnp.clip(tau_star - 1, 0, half - 1)
    t2 = jnp.clip(tau_star + 1, 0, half - 1)
    row = jnp.arange(n)
    y0, y1, y2 = cmndf[row, t0], cmndf[row, tau_star], cmndf[row, t2]
    denom = y0 - 2.0 * y1 + y2
    delta = jnp.where(jnp.abs(denom) < 1e-12, 0.0,
                      jnp.clip(0.5 * (y0 - y2) / denom, -1.0, 1.0))
    tau_refined = tau_star.astype(jnp.float32) + delta

    f0 = sample_rate / jnp.maximum(tau_refined, 1.0)
    conf = 1.0 - y1
    voiced = any_below & (f0 >= fmin) & (f0 <= fmax)
    return YinResult(jnp.where(voiced, f0, 0.0), conf, voiced)


def yin_pitch_np(frame: np.ndarray, sample_rate: float, fmin: float = 60.0,
                 fmax: float = 2000.0, threshold: float = DEFAULT_THRESHOLD):
    """Slow loop oracle for one frame (float64)."""
    w = len(frame)
    half = w // 2
    x = frame.astype(np.float64)
    tau_min = max(int(sample_rate / fmax), 1)
    tau_max = min(int(sample_rate / fmin) + 1, half - 1)
    d = np.zeros(half)
    for tau in range(1, half):
        diff = x[:half] - x[tau:tau + half]
        d[tau] = np.sum(diff * diff)
    cmndf = np.ones(half)
    cum = 0.0
    for tau in range(1, half):
        cum += d[tau]
        cmndf[tau] = d[tau] * tau / max(cum, 1e-12)
    tau_star = None
    for tau in range(tau_min, tau_max + 1):
        nxt = cmndf[tau + 1] if tau + 1 < half else cmndf[tau]
        if cmndf[tau] < threshold and nxt >= cmndf[tau]:
            tau_star = tau
            break
    voiced = tau_star is not None
    if not voiced:
        seg = np.where((np.arange(half) >= tau_min)
                       & (np.arange(half) <= tau_max), cmndf, np.inf)
        tau_star = int(np.argmin(seg))
    t0, t2 = max(tau_star - 1, 0), min(tau_star + 1, half - 1)
    y0, y1, y2 = cmndf[t0], cmndf[tau_star], cmndf[t2]
    denom = y0 - 2 * y1 + y2
    delta = 0.0 if abs(denom) < 1e-12 else float(np.clip(0.5 * (y0 - y2) / denom,
                                                         -1, 1))
    f0 = sample_rate / max(tau_star + delta, 1.0)
    return f0 if voiced and fmin <= f0 <= fmax else 0.0, voiced
