"""Real FFT magnitudes.

Replaces the reference's realfft/rustfft wrapper (ref src/dsp/fft.rs:1-102).
Two device backends:

* ``fft``  — `jnp.fft.rfft` (XLA's FFT lowering; cuFFT on the GPU).  The
  general default (DEFAULT_BACKEND) for full-spectrum magnitudes.
* ``dft``  — GEMM-native rDFT: `frames[N, W] @ trig[W, 2H]`, then a fused
  square/add/sqrt, at HIGHEST precision.  At full width it does far more
  FLOPs than an FFT, but the `band` parameter truncates it to the ~465-bin
  pitch candidate band, which makes it the pitch pipeline's backend
  (ops.stft.PITCH_BACKEND; a "_band" suffix names that use).  Which of the
  two is faster on the H100 is not measured yet.

Both return magnitude spectra `[..., W//2+1]` (or `[..., band]`) matching
`Complex::norm()`.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

# Full-spectrum default.  The pitch pipeline overrides it with the banded
# rDFT (ops.stft.PITCH_BACKEND), which consumes only the candidate band.
DEFAULT_BACKEND = "fft"
BACKENDS = ("fft", "dft")


def _base_backend(backend: str) -> str:
    """"dft_band" → "dft"; anything but the BACKENDS raises ValueError."""
    base = backend.removesuffix("_band")
    if base not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}, "
                         "optionally with a '_band' suffix")
    return base


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann, exactly the reference's formula (ref stft.rs:641-648)."""
    i = np.arange(n, dtype=np.float32)
    x = i / np.float32(n)
    return (np.float32(0.5) - np.float32(0.5)
            * np.cos(np.float32(2.0) * np.float32(np.pi) * x)).astype(np.float32)


@lru_cache(maxsize=8)
def _rdft_trig(n: int) -> np.ndarray:
    """[W, 2H] matrix with interleaved cos/-sin columns (built in float64)."""
    half = n // 2 + 1
    t = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(half, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * t * k / n
    trig = np.empty((n, 2 * half), dtype=np.float32)
    trig[:, 0::2] = np.cos(ang)
    trig[:, 1::2] = -np.sin(ang)
    return trig


@partial(jax.jit, static_argnames=("backend", "band"))
def rfft_mag(frames: jax.Array, backend: str = DEFAULT_BACKEND,
             band: int | None = None) -> jax.Array:
    """Magnitude spectrum of real frames: [..., W] → [..., B] float32.

    `band` (static): compute only the first `band` bins (B = band; default
    B = W//2+1).  The pitch pipeline consumes only the candidate band
    (`ops.pitch.candidate_band` + 1 bins; everything above the 10 kHz cap is
    unread — see models/analyzer.py), so a banded rDFT does ~2.2x less
    matmul work and writes ~2.2x fewer bins.  With backend "fft" the full FFT is
    still computed (XLA's FFT is monolithic); only the output write narrows.
    """
    backend = _base_backend(backend)
    n = frames.shape[-1]
    half = n // 2 + 1
    if band is None or band >= half:
        band = half
    if backend == "fft":
        mags = jnp.abs(jnp.fft.rfft(frames.astype(jnp.float32), axis=-1)).astype(jnp.float32)
        return mags if band == half else mags[..., :band]
    trig = jnp.asarray(_rdft_trig(n)[:, :2 * band])
    re_im = jax.lax.dot_general(
        frames.astype(jnp.float32), trig,
        dimension_numbers=(((frames.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    re_im = re_im.reshape(frames.shape[:-1] + (band, 2))
    return jnp.sqrt(re_im[..., 0] ** 2 + re_im[..., 1] ** 2)


@partial(jax.jit, static_argnames=("backend",))
def rfft_complex(frames: jax.Array, backend: str = DEFAULT_BACKEND):
    """(re, im) of the rDFT — for callers that need phase (e.g. inverse)."""
    backend = _base_backend(backend)
    n = frames.shape[-1]
    half = n // 2 + 1
    if backend == "fft":
        spec = jnp.fft.rfft(frames.astype(jnp.float32), axis=-1)
        return jnp.real(spec).astype(jnp.float32), jnp.imag(spec).astype(jnp.float32)
    trig = jnp.asarray(_rdft_trig(n))
    re_im = jax.lax.dot_general(
        frames.astype(jnp.float32), trig,
        dimension_numbers=(((frames.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).reshape(frames.shape[:-1] + (half, 2))
    return re_im[..., 0], re_im[..., 1]


@jax.jit
def irfft(re: jax.Array, im: jax.Array) -> jax.Array:
    """Inverse real FFT (ref FftProcessor::process_inverse, dsp/fft.rs:39-42).

    realfft's inverse is unnormalized (output scaled by N vs the true
    inverse); we match numpy/realfft convention: irfft(rfft(x)) * N == x * N.
    Here we return the *normalized* signal like `jnp.fft.irfft` — the
    reference never consumes the inverse in production paths.
    """
    return jnp.fft.irfft(re + 1j * im, axis=-1).astype(jnp.float32)


# ── NumPy oracle twins (float64) for parity tests ────────────────────────

def rfft_mag_np(frames: np.ndarray) -> np.ndarray:
    return np.abs(np.fft.rfft(frames.astype(np.float64), axis=-1))
