"""Automatic Gain Control + musical dynamics classification.

Port of DynamicsTracker (ref src/audio_io/dynamics.rs:1-374): per-slot RMS →
p10 of a 256-slot quiet-frame history (noise floor), kurtosis broadband
detector, 5000-slot play history → p50 session median + p95 AGC target,
smoothed gain with peak-headroom clamp 0.97, ppp…fff classification.

Device structure: one `lax.scan` over slots.  The reference sorts the 5000-entry
play history every slot; that is O(slots · n log n) and would dominate the
device program, so two modes are provided:

* ``exact``  — sort-based percentiles inside the scan (bit-faithful to the
  reference's index choices; use for parity tests / short audio).
* ``hist``   — incremental 1024-bucket dB histogram percentiles, O(buckets)
  per slot.  Percentile values quantize to the bucket width (0.182 dB over
  the [-180, 6] dB range) — well inside the AGC's 240 s smoothing time
  constant.  Default for long audio.  Composed-chain divergence vs the
  exact chain is measured in tests/test_fullchain_divergence.py and
  tools/fullchain_divergence.py.

Dynamic levels: Silence=-1, Ppp=0 … Fff=7 (ref dynamics.rs:49-77,672-686).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

LONG_LEN = 256        # ref dynamics.rs:164
PLAY_LEN = 5000       # ref dynamics.rs:168
TARGET_DB = -18.0     # ref mod.rs:344
MAX_BOOST_DB = 100.0  # ref mod.rs:345
SMOOTH_SECS = 240.0   # ref mod.rs:346
SILENCE_DECAY_SECS = 10.0
ACTIVE_SNR_DB = 20.0
BOOTSTRAP_FLOOR_DB = -55.0
PEAK_HEADROOM = 0.97

LEVEL_NAMES = ("silence", "ppp", "pp", "p", "mp", "mf", "f", "ff", "fff")

# Histogram range covers down to the -180 dB silence clamp (_lin_to_db's
# 1e-9 floor): digital-silence slots land in bucket 0 at ~-179.9 dB instead
# of clamping 60 dB high (which would poison the noise floor after silent
# sections).  1024 buckets over 186 dB → 0.182 dB quantization.
_HIST_BINS = 1024
_HIST_LO_DB = -180.0
_HIST_HI_DB = 6.0


def _lin_to_db(x):
    return 20.0 * jnp.log10(jnp.maximum(x, 1e-9))


def _db_to_lin(db):
    return 10.0 ** (db / 20.0)


class DynamicsState(NamedTuple):
    long_hist: jax.Array    # [LONG_LEN] rms_linear (+inf = unwritten)
    long_pos: jax.Array
    long_filled: jax.Array
    play_hist: jax.Array    # [PLAY_LEN]
    play_pos: jax.Array
    play_filled: jax.Array
    gain_linear: jax.Array
    # Histogram-mode accumulators (counts mirror the ring contents).
    long_counts: jax.Array  # [_HIST_BINS] int32
    play_counts: jax.Array  # [_HIST_BINS] int32


class DynamicsOut(NamedTuple):
    level: jax.Array              # int32: -1 silence … 7 fff
    rms_db: jax.Array
    gain_db: jax.Array            # applied gain (post headroom clamp)
    session_median_db: jax.Array
    noise_floor_db: jax.Array
    effective_gain: jax.Array     # linear gain actually applied to the slot


def init_state() -> DynamicsState:
    return DynamicsState(
        long_hist=jnp.full((LONG_LEN,), jnp.inf, jnp.float32),
        long_pos=jnp.asarray(0, jnp.int32),
        long_filled=jnp.asarray(False),
        play_hist=jnp.full((PLAY_LEN,), jnp.inf, jnp.float32),
        play_pos=jnp.asarray(0, jnp.int32),
        play_filled=jnp.asarray(False),
        gain_linear=jnp.asarray(1.0, jnp.float32),
        long_counts=jnp.zeros((_HIST_BINS,), jnp.int32),
        play_counts=jnp.zeros((_HIST_BINS,), jnp.int32),
    )


def _bucket_of(rms_linear):
    db = _lin_to_db(rms_linear)
    b = (db - _HIST_LO_DB) / (_HIST_HI_DB - _HIST_LO_DB) * _HIST_BINS
    return jnp.clip(b.astype(jnp.int32), 0, _HIST_BINS - 1)


def _bucket_value(bucket):
    """Linear rms at the bucket's center."""
    db = _HIST_LO_DB + (bucket.astype(jnp.float32) + 0.5) * (
        (_HIST_HI_DB - _HIST_LO_DB) / _HIST_BINS)
    return _db_to_lin(db)


def _hist_kth(counts, k):
    """Value of the k-th (0-based) smallest entry via cumulative counts."""
    cum = jnp.cumsum(counts)
    bucket = jnp.argmax(cum > k)
    return _bucket_value(bucket)


def _percentiles_exact(hist, n, idx_fns):
    srt = jnp.sort(hist)  # +inf padding lands at the end
    return [srt[i] for i in idx_fns(n)]


def _step(state: DynamicsState, slot: jax.Array, sample_rate: float,
          slot_len: int, mode: str):
    f32 = jnp.float32
    slot_rate = sample_rate / slot_len
    smooth_alpha = f32(1.0 - np.exp(-1.0 / (SMOOTH_SECS * slot_rate)))
    silence_alpha = f32(1.0 - np.exp(-1.0 / (SILENCE_DECAY_SECS * slot_rate)))

    # 1. Pre-gain RMS (ref dynamics.rs:195-200).
    sum_sq = jnp.sum(slot.astype(f32) ** 2)
    rms_linear = jnp.sqrt(sum_sq / slot.shape[0])
    rms_db = _lin_to_db(rms_linear)

    # 2. Noise floor = p10 of long history (ref dynamics.rs:202-220).
    long_n = jnp.where(state.long_filled, LONG_LEN,
                       jnp.maximum(state.long_pos, 1))
    p10_idx = ((long_n - 1).astype(f32) * 0.10).astype(jnp.int32)
    if mode == "exact":
        long_sorted = jnp.sort(state.long_hist)
        p10 = long_sorted[p10_idx]
    else:
        p10 = _hist_kth(state.long_counts, p10_idx)
    # Before any write the reference reads an unwritten 0.0 slot → -180 dB
    # (ref dynamics.rs:204-219: long_n = max(pos, 1) over a zeroed Vec).
    empty = (state.long_pos == 0) & ~state.long_filled
    p10 = jnp.where(empty, 0.0, p10)
    noise_floor_db = _lin_to_db(jnp.maximum(p10, 1e-9))

    # 3. Active gate (ref dynamics.rs:222-228).
    long_count = jnp.where(state.long_filled, LONG_LEN, state.long_pos)
    floor_db = jnp.where(long_count >= 32, noise_floor_db, BOOTSTRAP_FLOOR_DB)
    is_active = rms_db > floor_db + ACTIVE_SNR_DB

    # 3b. Kurtosis broadband detector (ref dynamics.rs:231-256).
    mean_sq = rms_linear * rms_linear
    mean_quad = jnp.sum(slot.astype(f32) ** 4) / slot.shape[0]
    kurtosis = jnp.where(mean_sq > 1e-18, mean_quad / (mean_sq * mean_sq), 3.0)
    is_broadband = is_active & (kurtosis >= 2.75) & (kurtosis <= 3.8) & (rms_db < -45.0)
    is_playing = is_active & ~is_broadband

    # Long history update: quiet OR broadband-active frames (dynamics.rs:263-271).
    upd_long = (~is_active) | is_broadband
    old_long = state.long_hist[state.long_pos]
    long_hist = jnp.where(upd_long,
                          state.long_hist.at[state.long_pos].set(rms_linear),
                          state.long_hist)
    long_pos = jnp.where(upd_long, (state.long_pos + 1) % LONG_LEN, state.long_pos)
    long_filled = state.long_filled | (upd_long & (long_pos == 0))
    long_counts = state.long_counts
    if mode == "hist":
        dec = jnp.where(upd_long & jnp.isfinite(old_long),
                        jnp.zeros_like(long_counts).at[_bucket_of(old_long)].set(1),
                        0)
        inc = jnp.where(upd_long,
                        jnp.zeros_like(long_counts).at[_bucket_of(rms_linear)].set(1),
                        0)
        long_counts = long_counts + inc - dec

    # 4. Play history update (dynamics.rs:273-281).
    old_play = state.play_hist[state.play_pos]
    play_hist = jnp.where(is_playing,
                          state.play_hist.at[state.play_pos].set(rms_linear),
                          state.play_hist)
    play_pos = jnp.where(is_playing, (state.play_pos + 1) % PLAY_LEN, state.play_pos)
    play_filled = state.play_filled | (is_playing & (play_pos == 0))
    play_counts = state.play_counts
    if mode == "hist":
        dec = jnp.where(is_playing & jnp.isfinite(old_play),
                        jnp.zeros_like(play_counts).at[_bucket_of(old_play)].set(1),
                        0)
        inc = jnp.where(is_playing,
                        jnp.zeros_like(play_counts).at[_bucket_of(rms_linear)].set(1),
                        0)
        play_counts = play_counts + inc - dec

    # 5. Session stats: p50 + p95 (dynamics.rs:283-307).
    play_n = jnp.where(play_filled, PLAY_LEN, play_pos)
    p50_idx = (play_n - 1) // 2
    p95_idx = ((play_n - 1).astype(f32) * 0.95).astype(jnp.int32)
    if mode == "exact":
        play_sorted = jnp.sort(play_hist)
        p50 = play_sorted[jnp.maximum(p50_idx, 0)]
        p95 = play_sorted[jnp.maximum(p95_idx, 0)]
    else:
        p50 = _hist_kth(play_counts, jnp.maximum(p50_idx, 0))
        p95 = _hist_kth(play_counts, jnp.maximum(p95_idx, 0))
    has_play = play_n > 0
    median_db = jnp.where(has_play, _lin_to_db(jnp.maximum(p50, 1e-9)), rms_db)
    p95_db = _lin_to_db(jnp.maximum(p95, 1e-9))
    raw_gain_db = jnp.where(has_play,
                            jnp.clip(TARGET_DB - p95_db, 0.0, MAX_BOOST_DB), 0.0)

    # 6. Smooth gain (dynamics.rs:309-316).
    target_linear = _db_to_lin(raw_gain_db)
    gain = jnp.where(
        is_playing,
        state.gain_linear + smooth_alpha * (target_linear - state.gain_linear),
        state.gain_linear + silence_alpha * (1.0 - state.gain_linear))

    # 7. Peak-headroom clamp (dynamics.rs:318-332).
    peak = jnp.maximum(jnp.max(jnp.abs(slot)), 1e-9)
    effective_gain = jnp.minimum(gain, PEAK_HEADROOM / peak)
    applied_gain_db = _lin_to_db(effective_gain)

    # 8. Classification (dynamics.rs:334-349).
    rel = rms_db - median_db
    level = jnp.where(
        ~is_playing, -1,
        jnp.where(rel < -15.0, 0,
        jnp.where(rel < -9.0, 1,
        jnp.where(rel < -4.5, 2,
        jnp.where(rel < -1.5, 3,
        jnp.where(rel < 1.5, 4,
        jnp.where(rel < 4.5, 5,
        jnp.where(rel < 9.0, 6, 7))))))))

    new_state = DynamicsState(long_hist, long_pos, long_filled,
                              play_hist, play_pos, play_filled, gain,
                              long_counts, play_counts)
    out = DynamicsOut(level.astype(jnp.int32), rms_db, applied_gain_db,
                      median_db, noise_floor_db, effective_gain)
    return new_state, out


@partial(jax.jit, static_argnames=("sample_rate", "slot_len", "mode"))
def dynamics_scan(state: DynamicsState, slots: jax.Array, sample_rate: float,
                  slot_len: int = 1024, mode: str = "hist"):
    """slots [S, slot_len] → (state, DynamicsOut [S] arrays, gained [S, L])."""
    def body(s, slot):
        ns, out = _step(s, slot, sample_rate, slot_len, mode)
        return ns, (out, slot * out.effective_gain)
    state, (outs, gained) = jax.lax.scan(body, state, slots)
    return state, outs, gained


# ── NumPy oracle: transcription of DynamicsTracker::process_slot ─────────

class DynamicsTrackerNp:
    """ref dynamics.rs:140-360 (float32, sort-based)."""

    def __init__(self, sample_rate, slot_len, target_db=TARGET_DB,
                 max_boost_db=MAX_BOOST_DB, smooth_secs=SMOOTH_SECS):
        slot_rate = sample_rate / slot_len
        self.long = np.zeros(LONG_LEN, np.float32)
        self.long_pos = 0
        self.long_filled = False
        self.play = np.zeros(PLAY_LEN, np.float32)
        self.play_pos = 0
        self.play_filled = False
        self.gain = np.float32(1.0)
        self.target_db = np.float32(target_db)
        self.max_boost = np.float32(max_boost_db)
        self.smooth_alpha = np.float32(1.0 - np.exp(-1.0 / (smooth_secs * slot_rate)))
        self.silence_alpha = np.float32(
            1.0 - np.exp(-1.0 / (SILENCE_DECAY_SECS * slot_rate)))

    def process_slot(self, slot: np.ndarray):
        f32 = np.float32
        slot = slot.astype(np.float32).copy()
        rms_linear = f32(np.sqrt(np.sum(slot * slot, dtype=np.float32) / len(slot)))
        rms_db = f32(20.0 * np.log10(max(rms_linear, 1e-9)))

        long_n = LONG_LEN if self.long_filled else max(self.long_pos, 1)
        buf = np.sort(self.long[:long_n])
        p10_idx = int((long_n - 1) * 0.10)
        noise_floor_db = (f32(20.0 * np.log10(max(buf[p10_idx], 1e-9)))
                          if long_n >= 1 else f32(BOOTSTRAP_FLOOR_DB))
        floor_db = noise_floor_db if long_n >= 32 else f32(BOOTSTRAP_FLOOR_DB)
        is_active = rms_db > floor_db + ACTIVE_SNR_DB

        if is_active:
            mean_sq = rms_linear * rms_linear
            mean_quad = f32(np.sum(slot ** 4, dtype=np.float32) / len(slot))
            kurtosis = (mean_quad / (mean_sq * mean_sq)
                        if mean_sq > 1e-18 else f32(3.0))
            is_broadband = bool(2.75 <= kurtosis <= 3.8 and rms_db < -45.0)
        else:
            is_broadband = False
        is_playing = is_active and not is_broadband

        if not is_active or is_broadband:
            self.long[self.long_pos] = rms_linear
            self.long_pos = (self.long_pos + 1) % LONG_LEN
            if self.long_pos == 0:
                self.long_filled = True
        if is_playing:
            self.play[self.play_pos] = rms_linear
            self.play_pos = (self.play_pos + 1) % PLAY_LEN
            if self.play_pos == 0:
                self.play_filled = True

        play_n = PLAY_LEN if self.play_filled else self.play_pos
        if play_n > 0:
            pbuf = np.sort(self.play[:play_n])
            p50_idx = (play_n - 1) // 2
            p95_idx = int((play_n - 1) * 0.95)
            median_db = f32(20.0 * np.log10(max(pbuf[p50_idx], 1e-9)))
            p95_db = f32(20.0 * np.log10(max(pbuf[p95_idx], 1e-9)))
            raw_gain_db = f32(np.clip(self.target_db - p95_db, 0.0, self.max_boost))
        else:
            raw_gain_db, median_db = f32(0.0), rms_db

        if is_playing:
            target_linear = f32(10.0 ** (raw_gain_db / 20.0))
            self.gain = f32(self.gain + self.smooth_alpha * (target_linear - self.gain))
        else:
            self.gain = f32(self.gain + self.silence_alpha * (1.0 - self.gain))

        peak = max(np.max(np.abs(slot)), 1e-9)
        effective = f32(min(self.gain, PEAK_HEADROOM / peak))
        slot *= effective
        applied_db = f32(20.0 * np.log10(max(effective, 1e-9)))

        if not is_playing:
            level = -1
        else:
            rel = rms_db - median_db
            level = (0 if rel < -15 else 1 if rel < -9 else 2 if rel < -4.5
                     else 3 if rel < -1.5 else 4 if rel < 1.5 else 5 if rel < 4.5
                     else 6 if rel < 9 else 7)
        return {"level": level, "rms_db": float(rms_db),
                "gain_db": float(applied_db),
                "session_median_db": float(median_db),
                "noise_floor_db": float(noise_floor_db),
                "slot": slot}
