"""Data-parallel batched analysis over a device mesh.

`batched_full_step` is the framework's "full step": the complete per-stream
analysis chain (reducer conditioning → AGC → pitch STFT pipeline → onset
pipeline) vmapped over a batch of independent streams and sharded over the
mesh's data axis with `shard_map`.  Per-frame features are embarrassingly
parallel across streams, so the only collectives are `psum`-based fleet
statistics (global mean noise floor / onset count).

This is the data-parallel reframing of SURVEY §2's "Parallelism" row: the
reference's thread pipeline becomes one SPMD program per shard.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import dynamics, noisefloor, onset as onset_ops, pitch as pitch_ops
from ..ops import reducer, tracker
from ..ops.stft import ONSET_WINDOW, PITCH_WINDOW, windowed_mags
from ..utils.framing import frame_signal
from .mesh import DATA_AXIS


class FullStepOut(NamedTuple):
    stable_freqs: jax.Array    # [B, Np, 8]
    stable_valid: jax.Array    # [B, Np, 8]
    onset_fired: jax.Array     # [B, No]
    onset_velocity: jax.Array  # [B, No]
    dyn_level: jax.Array       # [B, S]
    global_noise_floor_db: jax.Array  # scalar — psum'd fleet statistic
    global_onset_count: jax.Array     # scalar — psum'd fleet statistic


class StreamStates(NamedTuple):
    """Per-stream carried state for the full chain ([B, ...] leaves)."""
    red: reducer.ReducerState
    dyn: dynamics.DynamicsState
    nf: noisefloor.NoiseFloorState
    tr: tracker.TrackerState
    on: onset_ops.OnsetState


def init_stream_states(batch: int, half: int = PITCH_WINDOW // 2 + 1):
    def rep(x):
        return jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), x)
    return StreamStates(
        red=rep(reducer.reducer_init()),
        dyn=rep(dynamics.init_state()),
        nf=rep(noisefloor.init_state(half)),
        tr=rep(tracker.init_state()),
        on=rep(onset_ops.init_state()),
    )


def _single_stream_step(states: StreamStates, audio, sample_rate: float,
                        slot_len: int, pitch_hop: int, onset_hop: int,
                        dyn_mode: str = "hist"):
    """One stream's full analysis chain on a fixed-length audio chunk.

    `dyn_mode`: AGC percentile mode — "hist" (O(buckets)/slot, 0.18 dB
    quantization; measured output-identical to exact on the canonical mixed
    scene, tests/test_fullchain_divergence.py) or "exact" (sort-based)."""
    red, y = reducer.reduce_signal(states.red, audio, sample_rate)
    slots = y[: (y.shape[0] // slot_len) * slot_len].reshape(-1, slot_len)
    dyn, douts, gained = dynamics.dynamics_scan(states.dyn, slots, sample_rate,
                                                slot_len, mode=dyn_mode)
    cond = gained.reshape(-1)
    n_slots = slots.shape[0]

    def causal_floor_db(n_frames: int, window: int, hop: int):
        # Per-frame AGC noise floor: the floor as of the slot containing the
        # frame's last sample — the reference's STFT worker reads the shared
        # AGC floor right after the slot that completed the frame was pushed
        # (ref src/audio_io/stft.rs:322-324).  Broadcasting one chunk-final
        # value would be anticausal for every earlier frame.
        last = jnp.arange(n_frames, dtype=jnp.int32) * hop + (window - 1)
        slot_idx = jnp.minimum(last // slot_len, n_slots - 1)
        return douts.noise_floor_db[slot_idx]

    # Pitch pipeline.
    pframes = frame_signal(cond, PITCH_WINDOW, pitch_hop)
    pmags = windowed_mags(pframes, PITCH_WINDOW)
    half = PITCH_WINDOW // 2 + 1
    gf_db = douts.noise_floor_db[-1]
    gfp = noisefloor.global_floor_linear(
        causal_floor_db(pframes.shape[0], PITCH_WINDOW, pitch_hop), half)
    bin_width = sample_rate / PITCH_WINDOW
    nf, eff = noisefloor.noise_floor_scan(
        states.nf, pmags, gfp, pitch_ops.candidate_band(bin_width, half))
    pf = pitch_ops.extract_pitches(pmags, eff, bin_width)
    tr, (sf, ss, sv) = tracker.tracker_scan(
        states.tr, pf.freqs, pf.scores, pf.valid,
        jnp.zeros(pframes.shape[0], bool))

    # Onset pipeline.
    oframes = frame_signal(cond, ONSET_WINDOW, onset_hop)
    omags = windowed_mags(oframes, ONSET_WINDOW)
    ohalf = ONSET_WINDOW // 2 + 1
    gfo = noisefloor.global_floor_linear(
        causal_floor_db(oframes.shape[0], ONSET_WINDOW, onset_hop), ohalf)
    on, oouts = onset_ops.onset_scan(states.on, omags, gfo,
                                     jnp.zeros(oframes.shape[0], bool))

    new_states = StreamStates(red, dyn, nf, tr, on)
    return new_states, (sf, sv, oouts.fired, oouts.velocity, douts.level, gf_db)


def full_chain_np(audio, sample_rate: float, slot_len: int = 1024,
                  pitch_hop: int = 512, onset_hop: int = 64):
    """Exact NumPy oracle of `_single_stream_step` (one chunk, fresh state).

    Composes the exact-mode oracles end to end: sequential biquad + gate
    (reduce_signal_np — no blocked-scan approximation), sort-based AGC
    percentiles (DynamicsTrackerNp — no histogram quantization), per-slot
    causal floors, then the *_np pitch and onset pipelines.  Used to
    quantify the fast-mode (blocked biquad + hist AGC) divergence of the
    batched full step on realistic scenes (tools/fullchain_divergence.py,
    tests/test_fullchain_divergence.py).

    Returns a dict: stable (list of per-frame [(freq, score), ...]),
    onset_fired [No] bool, onset_velocity [No] f32, floors_db [S] f32.
    """
    import numpy as np

    from ..ops.pitch import extract_pitches_np
    from ..ops.stft import stft_mags_np
    from ..ops.tracker import PitchTrackerNp
    from ..utils.framing import num_frames

    audio = np.asarray(audio, np.float32)
    y = reducer.reduce_signal_np(audio, sample_rate)
    n_slots = len(y) // slot_len
    dyn = dynamics.DynamicsTrackerNp(sample_rate, slot_len)
    gained = np.empty(n_slots * slot_len, np.float32)
    floors_db = np.empty(n_slots, np.float32)
    for s in range(n_slots):
        out = dyn.process_slot(y[s * slot_len:(s + 1) * slot_len])
        gained[s * slot_len:(s + 1) * slot_len] = out["slot"]
        floors_db[s] = out["noise_floor_db"]

    def per_frame_floor_lin(n_frames, window, hop, half):
        last = np.arange(n_frames) * hop + (window - 1)
        idx = np.minimum(last // slot_len, n_slots - 1)
        return (10.0 ** (floors_db[idx].astype(np.float64) / 20.0)
                * (half / 2.0)).astype(np.float32)

    # Pitch chain.
    n_p = num_frames(len(gained), PITCH_WINDOW, pitch_hop)
    half = PITCH_WINDOW // 2 + 1
    pmags = stft_mags_np(gained, PITCH_WINDOW, pitch_hop).astype(np.float32)
    gfp = per_frame_floor_lin(n_p, PITCH_WINDOW, pitch_hop, half)
    eff = noisefloor.noise_floor_np(pmags, gfp)
    bin_width = float(np.float32(sample_rate) / np.float32(PITCH_WINDOW))
    tracker_np = PitchTrackerNp()
    stable = []
    for i in range(n_p):
        raw = extract_pitches_np(pmags[i], eff[i], bin_width)
        stable.append(tracker_np.process(raw, onset=False))

    # Onset chain.
    ohalf = ONSET_WINDOW // 2 + 1
    n_o = num_frames(len(gained), ONSET_WINDOW, onset_hop)
    omags = stft_mags_np(gained, ONSET_WINDOW, onset_hop).astype(np.float32)
    gfo = per_frame_floor_lin(n_o, ONSET_WINDOW, onset_hop, ohalf)
    oout = onset_ops.onset_np(omags, gfo, np.zeros(n_o, bool))
    return {"stable": stable, "onset_fired": oout["fired"],
            "onset_velocity": oout["velocity"], "floors_db": floors_db}


def make_batched_full_step(mesh: Mesh, sample_rate: float,
                           slot_len: int = 1024, pitch_hop: int = 512,
                           onset_hop: int = 64, dyn_mode: str = "hist"):
    """Build the jitted sharded full step: ([B,...] states, [B, T] audio) →
    (states, FullStepOut).  B must be divisible by the mesh size."""
    single = partial(_single_stream_step, sample_rate=sample_rate,
                     slot_len=slot_len, pitch_hop=pitch_hop,
                     onset_hop=onset_hop, dyn_mode=dyn_mode)

    def shard_fn(states, audio):
        states, (sf, sv, fired, vel, level, gf_db) = jax.vmap(single)(states, audio)
        # Fleet-wide aggregates: mean noise floor + total onsets (psum).
        local_b = audio.shape[0]
        total_b = local_b * jax.lax.psum(1, DATA_AXIS)
        global_floor = jax.lax.psum(jnp.sum(gf_db), DATA_AXIS) / total_b
        global_onsets = jax.lax.psum(jnp.sum(fired.astype(jnp.int32)), DATA_AXIS)
        return states, FullStepOut(sf, sv, fired, vel, level,
                                   global_floor, global_onsets)

    spec_b = P(DATA_AXIS)
    states_spec = jax.tree.map(lambda _: spec_b, init_stream_states(1))
    out_spec = FullStepOut(spec_b, spec_b, spec_b, spec_b, spec_b, P(), P())
    mapped = shard_map(shard_fn, mesh=mesh,
                       in_specs=(states_spec, spec_b),
                       out_specs=(states_spec, out_spec),
                       check_vma=False)
    return jax.jit(mapped)


def make_pooled_wave_step(mesh: Mesh, sample_rate: float,
                          slot_len: int = 1024, n_slots: int = 1):
    """The multi-chip classroom: K live sessions' slot waves partitioned
    over a device mesh.

    `api/pool.EnginePool` batches K engines' fused slot steps into one
    vmapped program (models/analyzer.fused_slot_pool_step); the engine
    axis is pure data parallelism (lanes never communicate), so sharding
    the stacked carries and host rows over the mesh's data axis runs the
    wave across chips via XLA SPMD with zero collectives — K scales with
    the mesh instead of one chip's VPU.  Returns `(place, step)`:

      place(stacked, host_vecs) -> same pytrees device_put with the
          engine axis sharded over the mesh (computation follows data);
      step(stacked, host_vecs, p_tail_len, o_tail_len) ->
          (new_stacked, packed) — fused_slot_pool_step_stacked with this
          wave geometry, outputs keeping the input shardings.

    Bitwise equality with the single-device pool step is pinned by
    tests/test_parallel.py and the driver's multichip dryrun
    (__graft_entry__.dryrun_multichip)."""
    from ..models.analyzer import fused_slot_pool_step_stacked

    sharding = NamedSharding(mesh, P(DATA_AXIS))

    def place(stacked, host_vecs):
        stacked = jax.device_put(
            stacked, jax.tree.map(lambda _: sharding, stacked))
        return stacked, jax.device_put(host_vecs, sharding)

    def step(stacked, host_vecs, p_tail_len: int, o_tail_len: int):
        return fused_slot_pool_step_stacked(
            stacked, host_vecs, sample_rate, slot_len, n_slots,
            p_tail_len, o_tail_len, pack=True)

    return place, step
