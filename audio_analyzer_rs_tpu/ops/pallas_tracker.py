"""Batched PitchTracker scan as one Pallas kernel (Triton route, GPU).

The XLA `tracker.tracker_scan` under `jax.vmap` is a `lax.scan` of tiny
[streams, 24] vector ops: each frame runs 8 greedy masked-min match rounds
and a cumsum spawn, which XLA lowers to a device loop of many small kernels
per frame — launch-bound, not math-bound.  This kernel runs the WHOLE frame
loop (`lax.fori_loop`) inside one program per block of streams, with the
carried state held in registers; per-frame raw pitches stream in and only
the per-frame emissions stream out.

Layout, for Triton's power-of-two blocks:
* state and emissions are [streams, 32]: the 24 track slots are padded to
  32 with invalid rows (seq = INT_MAX) that the spawn never fills;
* raw inputs are staged frames-major ([N, 8, S] and [N, S]) so each
  frame's load of a stream block is contiguous;
* `BLOCK_STREAMS` streams per program.  One is fastest on the H100: a
  128-segment batch runs as 128 programs on 128 of the 132 SMs, and each
  program's serial per-frame chain is shortest (PERF.md has the sweep).

Semantics are those of `tracker._step` (ref src/audio_io/stft.rs:20-117):
the greedy match takes the minimum creation-seq candidate by min+equality
(seqs are unique, INT_MAX on invalid slots — `argmin`'s first minimum), and
the spawn rank-matches unmatched raws to free slots through the same cumsum
ranks.  Integer and boolean results are exact; a frequency may differ from
the XLA scan in the last bit where the two compilers contract the EMA blend
`f*0.6 + raw*0.4` into an FMA differently.

Used by `tracker.tracker_scan_batched` on the GPU; the CPU tests run the
same kernel in interpret mode (tests/test_pallas_tracker.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .pitch import MAX_NOTES
from .tracker import (DISPLAY_THRESHOLD, EMA_NEW, EMA_OLD, MAX_LIFE,
                      MAX_TRACKS, TOLERANCE, TrackerState, select_stable)

_T = 32                     # MAX_TRACKS padded to a power of two
BLOCK_STREAMS = 1           # streams per program (see the module docstring)
NUM_WARPS = 1
_INT_MAX = np.int32(np.iinfo(np.int32).max)


def _kernel(rf_ref, rs_ref, rv_ref, on_ref,
            f0_ref, s0_ref, l0_ref, v0_ref, q0_ref, n0_ref,
            of_ref, os_ref, ot_ref, oq_ref,
            f1_ref, s1_ref, l1_ref, v1_ref, q1_ref, n1_ref,
            *, n_frames: int, bs: int):
    slot = jax.lax.broadcasted_iota(jnp.int32, (bs, _T), 1)
    real_slot = slot < MAX_TRACKS

    def body(i, carry):
        freq, score, life, valid, seq, nseq = carry
        onset = (on_ref[i, :] != 0)[:, None]                      # [bs, 1]
        matched = jnp.zeros((bs, _T), jnp.bool_)
        life_inc = jnp.minimum(life + 1, MAX_LIFE)
        rfs, rss, spawns = [], [], []
        # Phase 1: greedy matching in raw order (tracker._step; this
        # frame's updated tracks drop out of later rounds via `matched`,
        # so reading the running `freq` equals reading the entry state).
        for j in range(MAX_NOTES):
            rfj = rf_ref[i, j, :][:, None]                         # [bs, 1]
            rsj = rs_ref[i, j, :][:, None]
            rvj = (rv_ref[i, j, :] != 0)[:, None]
            rel_ok = (jnp.abs(freq - rfj)
                      / jnp.maximum(jnp.abs(freq), 1e-30)) < TOLERANCE
            masked_seq = jnp.where(valid & ~matched & rel_ok, seq, _INT_MAX)
            first = jnp.min(masked_seq, axis=1)[:, None]           # [bs, 1]
            any_match = (first < _INT_MAX) & rvj
            oh = (masked_seq == first) & any_match
            new_f = jnp.where(onset, rfj, freq * EMA_OLD + rfj * EMA_NEW)
            freq = jnp.where(oh, new_f, freq)
            score = jnp.where(oh, rsj, score)
            life = jnp.where(oh, life_inc, life)
            matched = matched | oh
            rfs.append(rfj)
            rss.append(rsj)
            spawns.append(rvj & ~any_match)

        # Phase 2: the r-th unmatched raw spawns into the r-th free real
        # slot (tracker._step's cumsum rank matching).
        free = ~valid & real_slot
        slot_rank = jnp.where(
            free, jnp.cumsum(free.astype(jnp.int32), axis=1) - 1, -1)
        raw_rank = jnp.zeros((bs, 1), jnp.int32)
        spawned = jnp.zeros((bs, _T), jnp.bool_)
        for j in range(MAX_NOTES):
            assign = (slot_rank == raw_rank) & spawns[j]
            freq = jnp.where(assign, rfs[j], freq)
            score = jnp.where(assign, rss[j], score)
            life = jnp.where(assign, 1, life)
            seq = jnp.where(assign, nseq + raw_rank, seq)
            spawned = spawned | assign
            raw_rank = raw_rank + spawns[j].astype(jnp.int32)
        matched = matched | spawned
        valid = valid | spawned
        nseq = nseq + jnp.sum(spawned.astype(jnp.int32), axis=1)[:, None]

        # Phase 3: misses decay, or are reaped on an onset.
        unmatched = valid & ~matched
        life = jnp.where(unmatched, jnp.where(onset, 0, life - 1), life)
        valid = valid & (life > 0)
        seq = jnp.where(valid, seq, _INT_MAX)

        of_ref[i] = freq
        os_ref[i] = score
        ot_ref[i] = (valid & (life >= DISPLAY_THRESHOLD)).astype(jnp.int32)
        oq_ref[i] = seq
        return freq, score, life, valid, seq, nseq

    init = (f0_ref[...], s0_ref[...], l0_ref[...], v0_ref[...] != 0,
            q0_ref[...], n0_ref[...])
    freq, score, life, valid, seq, nseq = jax.lax.fori_loop(
        0, n_frames, body, init)
    f1_ref[...] = freq
    s1_ref[...] = score
    l1_ref[...] = life
    v1_ref[...] = valid.astype(jnp.int32)
    q1_ref[...] = seq
    n1_ref[...] = nseq


@partial(jax.jit, static_argnames=("interpret", "block_streams"))
def tracker_scan_pallas(state: TrackerState, raw_freqs, raw_scores,
                        raw_valid, onsets, interpret: bool = False,
                        block_streams: int = BLOCK_STREAMS):
    """Batched tracker scan: state leaves carry a leading [S] axis; raw_*
    [S, N, 8], onsets [S, N] → (state, (freqs, scores, valid) [S, N, 8]),
    the contract of `jax.vmap(tracker.tracker_scan)`."""
    s, n, r = raw_freqs.shape
    bs = block_streams
    s_pad = -(-s // bs) * bs
    pad_s = s_pad - s

    def frames_major(a):
        """[S, N, ...] → [N, ..., S_pad]."""
        a = jnp.moveaxis(a, 0, -1)
        return jnp.pad(a, ((0, 0),) * (a.ndim - 1) + ((0, pad_s),))

    def pad_state(a, value=0):
        """[S, 24] → [S_pad, 32]; [S] → [S_pad, 1]."""
        if a.ndim == 1:
            return jnp.pad(a[:, None], ((0, pad_s), (0, 0)))
        return jnp.pad(a, ((0, pad_s), (0, _T - MAX_TRACKS)),
                       constant_values=value)

    rf = frames_major(raw_freqs.astype(jnp.float32))
    rs = frames_major(raw_scores.astype(jnp.float32))
    rv = frames_major(raw_valid.astype(jnp.int32))
    on = frames_major(onsets.astype(jnp.int32))
    init = (pad_state(state.freq.astype(jnp.float32)),
            pad_state(state.score.astype(jnp.float32)),
            pad_state(state.life.astype(jnp.int32)),
            pad_state(state.valid.astype(jnp.int32)),
            pad_state(state.seq.astype(jnp.int32), int(_INT_MAX)),
            pad_state(state.next_seq.astype(jnp.int32)))

    raw_spec = pl.BlockSpec((n, r, bs), lambda b: (0, 0, b))
    on_spec = pl.BlockSpec((n, bs), lambda b: (0, b))
    state_spec = pl.BlockSpec((bs, _T), lambda b: (b, 0))
    nseq_spec = pl.BlockSpec((bs, 1), lambda b: (b, 0))
    emit_spec = pl.BlockSpec((n, bs, _T), lambda b: (0, b, 0))
    state_specs = [state_spec] * 5 + [nseq_spec]
    emit_shape = [jax.ShapeDtypeStruct((n, s_pad, _T), dt) for dt in
                  (jnp.float32, jnp.float32, jnp.int32, jnp.int32)]
    state_shape = [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in init]
    outs = pl.pallas_call(
        partial(_kernel, n_frames=n, bs=bs),
        grid=(s_pad // bs,),
        in_specs=[raw_spec] * 3 + [on_spec] + state_specs,
        out_specs=[emit_spec] * 4 + state_specs,
        out_shape=emit_shape + state_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="tracker_scan",
    )(rf, rs, rv, on, *init)

    of, osc, ot, oq, f1, s1, l1, v1, q1, n1 = outs
    new_state = TrackerState(
        freq=f1[:s, :MAX_TRACKS], score=s1[:s, :MAX_TRACKS],
        life=l1[:s, :MAX_TRACKS], valid=v1[:s, :MAX_TRACKS] > 0,
        seq=q1[:s, :MAX_TRACKS], next_seq=n1[:s, 0])
    # Top-8 selection on the frames-major emissions, then [N, S] → [S, N].
    sel = select_stable(of[:, :s, :MAX_TRACKS], osc[:, :s, :MAX_TRACKS],
                        ot[:, :s, :MAX_TRACKS] > 0, oq[:, :s, :MAX_TRACKS])
    return new_state, tuple(jnp.swapaxes(x, 0, 1) for x in sel)
