"""PitchTracker — hysteresis over consecutive frames as a `lax.scan`.

Port of the reference tracker (ref src/audio_io/stft.rs:20-117): display after
2 hits, max life 3, 3% frequency tolerance, EMA 0.6/0.4 (snap on onset),
onset reaps unmatched tracks immediately.  The reference's growable Vec of
tracks becomes MAX_TRACKS fixed slots; relative (insertion) order — which the
Rust Vec preserves and the tuner's label join depends on — is reconstructed
by sorting emissions by a per-track creation sequence number.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# lax.scan unroll factor (amortizes per-step loop overhead; carried over
# from an earlier build, not re-swept on the H100).
SCAN_UNROLL = 16

from .pitch import MAX_NOTES

# 8 live raw pitches + up to 8 coasting (life<=3) tracks + headroom so a
# full-polyphony chord change never drops spawns (the reference Vec grows
# unboundedly; 24 slots make exhaustion practically unreachable since
# unmatched tracks die within 3 frames).
MAX_TRACKS = 24
DISPLAY_THRESHOLD = 2
MAX_LIFE = 3
TOLERANCE = 0.03
EMA_OLD, EMA_NEW = 0.6, 0.4


class TrackerState(NamedTuple):
    freq: jax.Array    # [T] float32
    score: jax.Array   # [T] float32
    life: jax.Array    # [T] int32
    valid: jax.Array   # [T] bool
    seq: jax.Array     # [T] int32 creation order
    next_seq: jax.Array  # scalar int32


def init_state() -> TrackerState:
    t = MAX_TRACKS
    return TrackerState(
        freq=jnp.zeros((t,), jnp.float32),
        score=jnp.zeros((t,), jnp.float32),
        life=jnp.zeros((t,), jnp.int32),
        valid=jnp.zeros((t,), bool),
        seq=jnp.full((t,), jnp.iinfo(jnp.int32).max, jnp.int32),
        next_seq=jnp.asarray(0, jnp.int32),
    )


def _step(state: TrackerState, raw_freq, raw_score, raw_valid, onset):
    """One frame.  Lean structure: the greedy matching loop (8 unrolled
    rounds of [MAX_TRACKS]-wide selects, no scatters) runs first; spawning is
    then fully vectorized by rank-matching unmatched raw pitches to free
    slots.  This is exact: a track spawned within a frame is immediately
    `matched` in the reference (ref stft.rs:76-83), so it can never be a
    match candidate for a later raw pitch of the same frame — matching is
    independent of spawns."""
    freq, score, life = state.freq, state.score, state.life
    valid, seq, next_seq = state.valid, state.seq, state.next_seq
    matched = jnp.zeros((MAX_TRACKS,), bool)
    iota = jnp.arange(MAX_TRACKS, dtype=jnp.int32)
    int_max = jnp.iinfo(jnp.int32).max

    # Hoisted per-frame values (tracks updated this frame are excluded via
    # `matched`, so entry-state precomputation is exact).
    rel_ok = (jnp.abs(freq[None, :] - raw_freq[:, None])
              / jnp.maximum(jnp.abs(freq[None, :]), 1e-30)) < TOLERANCE
    new_f_all = jnp.where(onset, raw_freq[:, None],
                          freq[None, :] * EMA_OLD + raw_freq[:, None] * EMA_NEW)
    life_inc = jnp.minimum(life + 1, MAX_LIFE)
    seq_masked0 = seq  # valid slots carry real seq; invalid carry int_max

    # Phase 1: greedy matching, raw order, first track in vec (seq) order.
    any_flags = []
    for i in range(MAX_NOTES):
        cand = valid & ~matched & rel_ok[i]
        any_match = jnp.any(cand) & raw_valid[i]
        first = jnp.argmin(jnp.where(cand, seq_masked0, int_max))
        oh = (iota == first) & any_match
        freq = jnp.where(oh, new_f_all[i], freq)
        score = jnp.where(oh, raw_score[i], score)
        life = jnp.where(oh, life_inc, life)
        matched = matched | oh
        any_flags.append(any_match)

    # Phase 2: vectorized spawn of unmatched raw pitches into free slots.
    unmatched_raw = raw_valid & ~jnp.stack(any_flags)          # [8]
    free = ~valid
    slot_rank = jnp.cumsum(free.astype(jnp.int32)) - 1         # rank among free
    slot_rank = jnp.where(free, slot_rank, -1)
    raw_rank = jnp.cumsum(unmatched_raw.astype(jnp.int32)) - 1
    raw_rank = jnp.where(unmatched_raw, raw_rank, -2)
    assign = slot_rank[None, :] == raw_rank[:, None]           # [8, 16]
    oh_s = jnp.any(assign, axis=0)
    # One-hot pickups at HIGHEST precision: a default-precision f32 dot
    # may run in TF32 on the GPU and round the picked frequency.
    a_f = assign.astype(jnp.float32)
    pick = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    freq = jnp.where(oh_s, pick(raw_freq, a_f), freq)
    score = jnp.where(oh_s, pick(raw_score, a_f), score)
    life = jnp.where(oh_s, 1, life)
    seq = jnp.where(oh_s, next_seq
                    + pick(jnp.maximum(raw_rank, 0).astype(jnp.float32),
                           a_f).astype(jnp.int32), seq)
    matched = matched | oh_s
    valid = valid | oh_s
    next_seq = next_seq + jnp.sum(oh_s.astype(jnp.int32))

    # 3. Misses: decay or (on onset) reap immediately (ref stft.rs:86-113).
    unmatched = valid & ~matched
    life = jnp.where(unmatched, jnp.where(onset, 0, life - 1), life)
    valid = valid & (life > 0)
    seq = jnp.where(valid, seq, int_max)

    # Emit the raw 16-slot snapshot; the stable-by-seq top-8 selection is a
    # batched post-scan pass (keeps the sequential scan step minimal).
    stable = valid & (life >= DISPLAY_THRESHOLD)
    new_state = TrackerState(freq, score, life, valid, seq, next_seq)
    return new_state, (freq, score, stable, seq)


@jax.jit
def tracker_scan(state: TrackerState, raw_freqs, raw_scores, raw_valid,
                 onsets):
    """raw_* [N, 8], onsets [N] bool → (state, (freqs, scores, valid) [N, 8]).

    Emissions are stable tracks (life >= 2) in creation order, capped at 8
    (the Rust Vec preserves insertion order; ref stft.rs:106-112)."""
    def body(s, inp):
        rf, rs, rv, on = inp
        return _step(s, rf, rs, rv, on)
    state, (freq, score, stable, seq) = jax.lax.scan(
        body, state, (raw_freqs, raw_scores, raw_valid, onsets),
        unroll=SCAN_UNROLL)
    return state, select_stable(freq, score, stable, seq)


def select_stable(freq, score, stable, seq):
    """Batched (parallel over frames) stable-by-seq top-8 selection,
    sort-free: rank[i] = #{j : (key_j, j) < (key_i, i)} via a [T, T]
    comparison count (stable keys are unique seqs < int_max, so stable
    ranks are exactly the argsort positions), then a one-hot scatter emits
    the first 8, with no sort (XLA sorts lower to bitonic networks) and no
    gather.  Slots with valid=False are zeroed (the
    former argsort gather carried unspecified values there).

    Inputs [..., T]; outputs [..., MAX_NOTES]."""
    int_max = jnp.iinfo(jnp.int32).max
    keys = jnp.where(stable, seq, int_max)                   # [..., T]
    iota = jnp.arange(MAX_TRACKS, dtype=jnp.int32)
    kj, ki = keys[..., None, :], keys[..., :, None]
    less = (kj < ki) | ((kj == ki) & (iota[None, :] < iota[:, None]))
    rank = jnp.sum(less, axis=-1).astype(jnp.int32)          # [..., T]
    sel = stable & (rank < MAX_NOTES)
    onehot = (jnp.where(sel, rank, MAX_NOTES)[..., None]
              == jnp.arange(MAX_NOTES, dtype=jnp.int32))     # [..., T, 8]
    ohf = onehot.astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    out_freq = jnp.einsum("...t,...ts->...s", freq, ohf, precision=hi)
    out_score = jnp.einsum("...t,...ts->...s", score, ohf, precision=hi)
    out_valid = jnp.any(onehot, axis=-2)
    return out_freq, out_score, out_valid


_IMPLS = ("xla", "pallas", "pallas_interpret")


@partial(jax.jit, static_argnames=("impl", "mesh"))
def tracker_scan_batched(state: TrackerState, raw_freqs, raw_scores,
                         raw_valid, onsets, impl: str | None = None,
                         mesh=None):
    """Segment-batched tracker scan: state leaves carry a leading [S] axis;
    raw_* [S, N, 8], onsets [S, N] → (state, (freqs, scores, valid)
    [S, N, 8]).

    impl: "pallas" (the whole frame scan as one Triton kernel per block of
    streams — ops/pallas_tracker.py; GPU only), "pallas_interpret" (the
    same kernel interpreted, for CPU tests), "xla" (vmap of
    `tracker_scan`), or None → "pallas" on the GPU, else "xla".  Integer
    and boolean outputs agree exactly, frequencies to the last bit
    (tests/test_pallas_tracker.py).

    mesh: the 1-D mesh the leading axis is sharded over, if any; the
    kernel then runs per shard under `shard_map` instead of having its
    operands gathered onto every device."""
    if impl is None:
        impl = "pallas" if jax.devices()[0].platform == "gpu" else "xla"
    if impl not in _IMPLS:
        raise ValueError(f"impl={impl!r}: expected one of {_IMPLS}")
    if impl == "xla":
        return jax.vmap(tracker_scan)(state, raw_freqs, raw_scores,
                                      raw_valid, onsets)
    from .pallas_tracker import tracker_scan_pallas
    scan = partial(tracker_scan_pallas, interpret=impl == "pallas_interpret")
    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        from ..parallel.mesh import DATA_AXIS
        scan = jax.shard_map(scan, mesh=mesh, in_specs=(P(DATA_AXIS),) * 5,
                             out_specs=P(DATA_AXIS), check_vma=False)
    return scan(state, raw_freqs, raw_scores, raw_valid, onsets)


# ── NumPy oracle: transcription of the Rust PitchTracker ─────────────────

class PitchTrackerNp:
    """ref stft.rs:20-117, list-based."""

    def __init__(self):
        self.tracks = []  # [freq, score, life]

    def process(self, raw_pitches, onset: bool):
        matched = [False] * len(self.tracks)
        for raw_freq, raw_score in raw_pitches:
            found = False
            for i, tr in enumerate(self.tracks):
                if matched[i]:
                    continue
                if abs(tr[0] - raw_freq) / tr[0] < TOLERANCE:
                    tr[0] = raw_freq if onset else tr[0] * EMA_OLD + raw_freq * EMA_NEW
                    tr[1] = raw_score
                    tr[2] = min(tr[2] + 1, MAX_LIFE)
                    matched[i] = True
                    found = True
                    break
            if not found:
                self.tracks.append([raw_freq, raw_score, 1])
                matched.append(True)
        active = []
        i = 0
        while i < len(self.tracks):
            if not matched[i]:
                self.tracks[i][2] = 0 if onset else self.tracks[i][2] - 1
            if self.tracks[i][2] <= 0:
                self.tracks.pop(i)
                if len(matched) > i:
                    matched.pop(i)
            else:
                if self.tracks[i][2] >= DISPLAY_THRESHOLD:
                    active.append((self.tracks[i][0], self.tracks[i][1]))
                i += 1
        return active
