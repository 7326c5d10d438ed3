"""Hop-strided framing: arbitrary-length audio → fixed-shape [frames, window].

The batched replacement for the reference's per-thread ring buffers
(ref src/audio_io/stft.rs:198-201,436-437 and src/analysis/onset.rs:143-146):
instead of a ring buffer advanced by `hop` per iteration, the whole signal is
framed into a `[num_frames, window]` tensor (a strided gather XLA fuses into
consumers), and sequential per-frame state is carried by `lax.scan`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def num_frames(n_samples: int, window: int, hop: int) -> int:
    """Frames produced by the reference ring-buffer loop: while avail >= window."""
    if n_samples < window:
        return 0
    return (n_samples - window) // hop + 1


@partial(jax.jit, static_argnames=("window", "hop"))
def frame_signal(x: jax.Array, window: int, hop: int) -> jax.Array:
    """[n] float32 → [num_frames, window] float32 (zero-copy gather under XLA)."""
    n = num_frames(x.shape[0], window, hop)
    starts = jnp.arange(n, dtype=jnp.int32) * hop
    idx = starts[:, None] + jnp.arange(window, dtype=jnp.int32)[None, :]
    return x[idx]


def frame_signal_np(x: np.ndarray, window: int, hop: int) -> np.ndarray:
    """NumPy oracle twin of `frame_signal` for parity tests."""
    n = num_frames(len(x), window, hop)
    out = np.empty((n, window), dtype=np.float32)
    for i in range(n):
        out[i] = x[i * hop:i * hop + window]
    return out


def pad_to_frames(x: np.ndarray, window: int, hop: int) -> np.ndarray:
    """Zero-pad the tail so every sample lands in at least one full frame."""
    n = len(x)
    if n < window:
        return np.pad(x, (0, window - n)).astype(np.float32)
    rem = (n - window) % hop
    if rem:
        x = np.pad(x, (0, hop - rem))
    return x.astype(np.float32)
