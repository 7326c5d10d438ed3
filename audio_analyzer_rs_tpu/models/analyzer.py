"""Analyzer pipelines — the flagship composed models.

`PitchAnalyzer` is the batched-JAX equivalent of the reference's STFT worker
thread (ref src/audio_io/stft.rs:155-441): frame → Hann → rDFT magnitude →
variance-aware per-bin noise floor (scan) → harmonic-comb pitch extraction
(vmap) → PitchTracker hysteresis (scan).  `OnsetAnalyzer` is the equivalent
of the onset thread (ref src/analysis/onset.rs:104-546).  Both are streaming:
state in, state out — a chunk of any length advances them, so the same jitted
program serves offline batch analysis and the realtime virtual device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import noisefloor, onset as onset_ops, pitch as pitch_ops, tracker
from ..ops.stft import (DEFAULT_BACKEND, PITCH_BACKEND, PITCH_HOP,
                        PITCH_WINDOW, ONSET_HOP, ONSET_WINDOW, windowed_mags)
from ..utils.framing import frame_signal, num_frames


class PitchChunkOut(NamedTuple):
    raw_freqs: jax.Array     # [N, 8]
    raw_scores: jax.Array    # [N, 8]
    raw_valid: jax.Array     # [N, 8]
    stable_freqs: jax.Array  # [N, 8]
    stable_scores: jax.Array  # [N, 8]
    stable_valid: jax.Array  # [N, 8]
    mags: jax.Array          # [N, H]
    eff_floor: jax.Array     # [N, H] (zeros unless return_floor)


@partial(jax.jit, static_argnames=("sample_rate", "window", "hop", "backend",
                                   "return_floor", "comb"))
def pitch_extract_frames(nf_state, frames, global_floor,
                         sample_rate: float, window: int = PITCH_WINDOW,
                         hop: int = PITCH_HOP, backend: str = PITCH_BACKEND,
                         return_floor: bool = False,
                         comb: str | None = None):
    """The frame-parallel front of the pitch pipeline (no tracker):
    pre-framed audio [N, window] → (nf_state, PitchFrame, mags, eff_floor).

    `comb`: harmonic-comb backend (ops/pitch.py DEFAULT_COMB when None).

    A backend suffixed "_band" (e.g. "dft_band") computes only the
    candidate-band spectrum bins [0, kc+1) — everything the pitch pipeline
    reads (peaks, parabolic interp, floor recurrence, comb slab) lives
    below the 10 kHz cap, so outputs are identical while the rDFT does
    ~2.2x less work.  The returned `mags` is then [N, kc+1]; `return_floor`
    (devtools, wants the full surface) falls back to the full-width base
    backend."""
    half = window // 2 + 1
    bin_width = float(np.float32(sample_rate) / np.float32(window))
    # Band the floor recurrence to the pitch candidate bins unless the
    # caller wants the full floor surface (devtools) — output-exact, ~2.2x
    # less scan work (see noisefloor.noise_floor_scan).
    band = None if return_floor else pitch_ops.candidate_band(bin_width, half)
    if backend.endswith("_band"):
        base = backend[:-len("_band")]
        stft_band = None if band is None else band + 1
        mags = windowed_mags(frames, window, backend=base, band=stft_band)
    else:
        mags = windowed_mags(frames, window, backend=backend)
    nf_state, eff_floor = noisefloor.noise_floor_scan(nf_state, mags,
                                                      global_floor, band)
    pf = pitch_ops.extract_pitches(mags, eff_floor, bin_width, comb=comb,
                                   true_half=half)
    return nf_state, pf, mags, eff_floor


@partial(jax.jit, static_argnames=("sample_rate", "window", "backend"))
def floor_warmup_frames(nf_state, frames, global_floor,
                        sample_rate: float, window: int = PITCH_WINDOW,
                        backend: str = PITCH_BACKEND):
    """STFT + noise-floor scan ONLY: pre-framed audio [N, window] →
    nf_state, with the comb/tracker stages skipped entirely.

    The segment-parallel warmup (models/segmented.py `warmup_mode="floor"`)
    discards every output of its look-back frames, so only the floor
    IIR state needs computing there — and the comb is ~70% of the full
    step (not measured on the H100).  The
    banding and mags
    computation mirror `pitch_extract_frames` exactly (same constants,
    same windowed_mags call shape per frame), so the floor recurrence sees
    the same inputs the full step would."""
    half = window // 2 + 1
    bin_width = float(np.float32(sample_rate) / np.float32(window))
    band = pitch_ops.candidate_band(bin_width, half)
    if backend.endswith("_band"):
        base = backend[:-len("_band")]
        mags = windowed_mags(frames, window, backend=base, band=band + 1)
    else:
        mags = windowed_mags(frames, window, backend=backend)
    nf_state, _ = noisefloor.noise_floor_scan(nf_state, mags, global_floor,
                                              band)
    return nf_state


@partial(jax.jit, static_argnames=("sample_rate", "window", "hop", "backend",
                                   "return_floor", "comb"))
def pitch_analyze_frames(nf_state, tr_state, frames, global_floor, onsets,
                         sample_rate: float, window: int = PITCH_WINDOW,
                         hop: int = PITCH_HOP, backend: str = PITCH_BACKEND,
                         return_floor: bool = False,
                         comb: str | None = None):
    """Pre-framed audio [N, window] → pitch pipeline outputs + new states.

    `pitch_extract_frames` (the frame-parallel stages) + the tracker scan;
    see its docstring for the `backend`/`comb`/`return_floor` contracts.
    The segment-batched hot path (models/segmented.py) instead calls the
    extraction under vmap and `tracker.tracker_scan_batched` outside it
    (one Pallas kernel on the GPU — ops/pallas_tracker.py) — outputs
    bitwise-identical."""
    nf_state, pf, mags, eff_floor = pitch_extract_frames(
        nf_state, frames, global_floor, sample_rate, window, hop, backend,
        return_floor, comb)
    tr_state, (sf, ss, sv) = tracker.tracker_scan(
        tr_state, pf.freqs, pf.scores, pf.valid, onsets)
    floor_out = eff_floor if return_floor else jnp.zeros((0, 0), jnp.float32)
    return nf_state, tr_state, PitchChunkOut(pf.freqs, pf.scores, pf.valid,
                                             sf, ss, sv, mags, floor_out)


@dataclass
class PitchAnalyzer:
    """Streaming pitch detection (ring buffer + device scans).

    Mirrors the reference worker's ring-buffer semantics: samples accumulate
    until >= window, then frames advance by hop (ref stft.rs:268-273,436-437).
    """
    sample_rate: float
    window: int = PITCH_WINDOW
    hop: int = PITCH_HOP
    backend: str = PITCH_BACKEND
    debug_recorder: object = None    # devtools.DebugRecorder (optional)
    # Device-memory bound for one jitted call: extract_pitches materializes
    # ~[n, 14*half] comb transients, so a single process() over an hour of
    # audio (310k frames) would need ~18 GB HBM.  Larger inputs are split
    # into max_chunk_frames pieces with state carried — sequential
    # semantics are identical (the pipeline is a scan).
    max_chunk_frames: int = 4096
    _tail: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def __post_init__(self):
        self.nf_state = noisefloor.init_state(self.window // 2 + 1)
        self.tr_state = tracker.init_state()
        self.frames_consumed = 0

    def reset(self):
        self._tail = np.zeros(0, np.float32)
        self.nf_state = noisefloor.init_state(self.window // 2 + 1)
        self.tr_state = tracker.init_state()
        self.frames_consumed = 0

    def process(self, samples: np.ndarray, global_floor_db: float = -96.0,
                onset_pending: Optional[np.ndarray] = None,
                onset_first: bool = False):
        """Feed a chunk; returns per-frame outputs (may be empty).

        `onset_pending`: optional [n_frames] bool — the onset_pending flag the
        onset detector sets (ref stft.rs:387).  `onset_first` marks just the
        first frame of this burst (the streaming engine's one-shot flag).
        """
        buf = np.concatenate([self._tail, np.asarray(samples, np.float32)])
        n = num_frames(len(buf), self.window, self.hop)
        if n == 0:
            self._tail = buf
            return None
        consumed = n * self.hop
        self._tail = buf[consumed:]
        half = self.window // 2 + 1
        gf_lin = float(noisefloor.global_floor_linear(global_floor_db, half))
        if onset_pending is not None:
            onsets = np.asarray(onset_pending, bool)[:n]
        else:
            onsets = np.zeros(n, bool)
            if onset_first:
                onsets[0] = True
        buf_dev = jnp.asarray(buf)
        outs = []
        for c0 in range(0, n, self.max_chunk_frames):
            c1 = min(c0 + self.max_chunk_frames, n)
            # Frame on device and keep the [m, window] array there — pulling
            # it to host would round-trip a 4x-expanded copy of the audio.
            sl = buf_dev[c0 * self.hop:(c1 - 1) * self.hop + self.window]
            frames = frame_signal(sl, self.window, self.hop)
            gf = jnp.full(c1 - c0, gf_lin, jnp.float32)
            self.nf_state, self.tr_state, out = pitch_analyze_frames(
                self.nf_state, self.tr_state, frames, gf,
                jnp.asarray(onsets[c0:c1]), self.sample_rate, self.window,
                self.hop, self.backend,
                return_floor=self.debug_recorder is not None)
            outs.append(out)
        out = outs[0] if len(outs) == 1 else jax.tree.map(
            lambda *xs: jnp.concatenate(xs), *outs)
        # Batched readback: device_get issues copy_to_host_async() on every
        # leaf before gathering, so the 8 output leaves cost ~one blocking
        # host<->device round trip instead of 8 (per-leaf np.asarray blocks
        # each time).
        out = jax.device_get(out)
        if self.debug_recorder is not None:
            bin_width = self.sample_rate / self.window
            for i in range(n):
                stable = [(float(f), float(s)) for f, s, v in
                          zip(out.stable_freqs[i], out.stable_scores[i],
                              out.stable_valid[i]) if v]
                self.debug_recorder.log_pitch_frame(
                    self.frames_consumed + i, out.mags[i], out.eff_floor[i],
                    bin_width, stable)
        self.frames_consumed += n
        return out


class OnsetChunkOut(NamedTuple):
    fired: jax.Array
    detected: jax.Array
    velocity: jax.Array
    flux: jax.Array
    energy: jax.Array
    burst_count: jax.Array
    energy_rising: jax.Array
    frames_since: jax.Array


@partial(jax.jit, static_argnames=("window", "backend"))
def onset_analyze_frames(state, frames, global_floor, tick_suppressed,
                         calibration_hold=None,
                         window: int = ONSET_WINDOW, backend: str = DEFAULT_BACKEND):
    mags = windowed_mags(frames, window, backend=backend)
    state, out = onset_ops.onset_scan(state, mags, global_floor,
                                      tick_suppressed, calibration_hold)
    return state, OnsetChunkOut(out.fired, out.detected, out.velocity,
                                out.flux, out.energy, out.burst_count,
                                out.energy_rising, out.frames_since)


def pack_fused_out(outs) -> jax.Array:
    """Flatten a FusedSlotOut (or a tuple of them) into ONE f32 vector.

    Each array fetched from the device pays a per-buffer overhead; a
    FusedSlotOut is 11 small arrays, so reading a slot (or an A-slot
    aggregate: 11*A arrays) back leaf-by-leaf costs more link time than the
    bytes.  Bool
    and int32 leaves cast exactly to f32 (0/1 flags; counters << 2^24), so
    one packed vector per readback is bit-faithful."""
    return jnp.concatenate([jnp.ravel(l).astype(jnp.float32)
                            for l in jax.tree.leaves(outs)])


def fused_out_len(n_p: int, n_o: int) -> int:
    """Packed length of one FusedSlotOut with n_p pitch / n_o onset frames."""
    return 3 * n_p * 8 + 8 * n_o


def unpack_fused_out(vec: np.ndarray, n_p: int, n_o: int) -> "FusedSlotOut":
    """Host-side inverse of `pack_fused_out` for a single FusedSlotOut.

    The leaf order/dtypes mirror FusedSlotOut/OnsetChunkOut field order
    (= jax.tree.leaves order for NamedTuples); test_fused_streaming pins
    the round trip."""
    vec = np.asarray(vec, np.float32)
    off = 0

    def take(n, shape, dtype):
        nonlocal off
        part = vec[off:off + n]
        off += n
        part = part.reshape(shape)
        if dtype is bool:
            return part > 0.5
        return part.astype(dtype) if dtype is not np.float32 else part

    sf = take(n_p * 8, (n_p, 8), np.float32)
    ss = take(n_p * 8, (n_p, 8), np.float32)
    sv = take(n_p * 8, (n_p, 8), bool)
    onset = OnsetChunkOut(
        take(n_o, (n_o,), bool), take(n_o, (n_o,), bool),
        take(n_o, (n_o,), np.float32), take(n_o, (n_o,), np.float32),
        take(n_o, (n_o,), np.float32), take(n_o, (n_o,), np.int32),
        take(n_o, (n_o,), bool), take(n_o, (n_o,), np.int32))
    return FusedSlotOut(sf, ss, sv, onset)


class FusedSlotOut(NamedTuple):
    """Per-slot readback of `fused_slot_step` (the live engine's fused path).

    Pitch fields are the tracker's stable outputs ([n_p, 8] — all the live
    tuner consumes, ref stft.rs:387-390); `onset` carries the full onset
    per-frame record ([n_o] each).  The ring-buffer tails and the pending
    flag are NOT here: they stay device-resident across slots (returned as
    separate carries) so a slot never round-trips them through the host."""
    stable_freqs: jax.Array
    stable_scores: jax.Array
    stable_valid: jax.Array
    onset: OnsetChunkOut


@partial(jax.jit, static_argnames=("sample_rate", "slot_len", "p_tail_len",
                                   "o_tail_len", "p_window", "p_hop",
                                   "o_window", "o_hop", "pitch_backend",
                                   "onset_backend", "pack"))
def fused_slot_step(nf_state, tr_state, onset_state, pending,
                    p_tail, o_tail, host_vec,
                    sample_rate: float, slot_len: int, p_tail_len: int,
                    o_tail_len: int, p_window: int = PITCH_WINDOW,
                    p_hop: int = PITCH_HOP, o_window: int = ONSET_WINDOW,
                    o_hop: int = ONSET_HOP,
                    pitch_backend: str = PITCH_BACKEND,
                    onset_backend: str = DEFAULT_BACKEND,
                    pack: bool = False):
    """One device program per realtime audio slot: both live flows fused,
    ring tails and the onset->pitch pending flag carried ON DEVICE.

    The reference's realtime engine runs one onset thread and one pitch
    thread per audio callback (ref src/audio_io/mod.rs:657-938); the
    rebuild's per-consumer device steps issue ~17 host<->device round trips
    per 1024-sample slot, which dominates streaming latency on any link
    slower than PCIe (tools/engine_rt_bench.py).  This step reduces the
    slot's host traffic to ONE small upload (`host_vec`: the raw audio plus
    a few scalars) and one deferred readback of `FusedSlotOut`: the ring
    tails, analyzer states, and the pending flag are jit outputs fed back
    as jit inputs — they never leave the device — so consecutive slots'
    upload, compute, and readback can overlap (api/engine.py pipelines the
    readback by `pipeline_depth` slots).

    `host_vec` layout (all f32):
        [slot | gf_pitch_lin | gf_onset_lin | calibration_hold |
         tick_suppressed (n_o entries, 0/1)]
    where n_p/n_o = num_frames(tail+slot) are implied by the static lengths.

    Semantics are identical to running `onset_analyze_frames` then
    `pitch_analyze_frames` with onsets[0] = pending | any(fired) — the
    engine's sequential consumer order (api/engine.py _input_callback).
    Calibration is folded in as the `calibration_hold` data input (the
    onset scan's hold vector, ref src/analysis/onset.rs:359-440), so ONE
    program family serves the whole session including the calibration
    ramp; while holding, fires do not reach the pitch tracker — matching
    the sequential path, where pre-calibration events never set the
    engine's onset_pending flag.

    `pending` carries a fired-but-not-yet-consumed onset flag across slots
    (ref stft.rs:387's swap): it is only left set by ramp-up slots that
    produce no pitch frame (n_p == 0); any slot with pitch frames consumes
    it into frame 0.
    """
    slot = host_vec[:slot_len]
    gf_p = host_vec[slot_len]
    gf_o = host_vec[slot_len + 1]
    hold = host_vec[slot_len + 2] > 0.5
    n_p = num_frames(p_tail_len + slot_len, p_window, p_hop)
    n_o = num_frames(o_tail_len + slot_len, o_window, o_hop)
    tick_sup = host_vec[slot_len + 3:slot_len + 3 + n_o] > 0.5

    # Onset flow first (engine consumer order: the onset_pending flag set by
    # this slot's fires reaches the pitch tracker in the same burst).
    o_buf = jnp.concatenate([o_tail, slot]) if o_tail_len else slot
    fired_any = jnp.asarray(False)
    if n_o:
        o_frames = frame_signal(o_buf[:(n_o - 1) * o_hop + o_window],
                                o_window, o_hop)
        onset_state, o_out = onset_analyze_frames(
            onset_state, o_frames, jnp.full((n_o,), gf_o, jnp.float32),
            tick_sup, jnp.broadcast_to(hold, (n_o,)), o_window, onset_backend)
        fired_any = o_out.fired.any() & ~hold
    else:                                                 # ramp-up variants
        zf = jnp.zeros((0,), jnp.float32)
        zb = jnp.zeros((0,), bool)
        zi = jnp.zeros((0,), jnp.int32)
        o_out = OnsetChunkOut(zb, zb, zf, zf, zf, zi, zb, zi)
    o_new_tail = o_buf[n_o * o_hop:]

    p_buf = jnp.concatenate([p_tail, slot]) if p_tail_len else slot
    if n_p:
        p_frames = frame_signal(p_buf[:(n_p - 1) * p_hop + p_window],
                                p_window, p_hop)
        onsets = jnp.zeros((n_p,), bool).at[0].set(pending | fired_any)
        nf_state, tr_state, pout = pitch_analyze_frames(
            nf_state, tr_state, p_frames, jnp.full((n_p,), gf_p, jnp.float32),
            onsets, sample_rate, p_window, p_hop, pitch_backend)
        sf, ss, sv = pout.stable_freqs, pout.stable_scores, pout.stable_valid
        pending = jnp.asarray(False)
    else:
        sf = jnp.zeros((0, 8), jnp.float32)
        ss = jnp.zeros((0, 8), jnp.float32)
        sv = jnp.zeros((0, 8), bool)
        pending = pending | fired_any
    p_new_tail = p_buf[n_p * p_hop:]
    out = FusedSlotOut(sf, ss, sv, o_out)
    return (nf_state, tr_state, onset_state, pending, p_new_tail, o_new_tail,
            pack_fused_out(out) if pack else out)


@partial(jax.jit, static_argnames=("sample_rate", "slot_len", "n_slots",
                                   "p_tail_len", "o_tail_len", "p_window",
                                   "p_hop", "o_window", "o_hop",
                                   "pitch_backend", "onset_backend", "pack"))
def fused_slot_agg_step(nf_state, tr_state, onset_state, pending,
                        p_tail, o_tail, host_vec,
                        sample_rate: float, slot_len: int, n_slots: int,
                        p_tail_len: int, o_tail_len: int,
                        p_window: int = PITCH_WINDOW,
                        p_hop: int = PITCH_HOP, o_window: int = ONSET_WINDOW,
                        o_hop: int = ONSET_HOP,
                        pitch_backend: str = PITCH_BACKEND,
                        onset_backend: str = DEFAULT_BACKEND,
                        pack: bool = False):
    """`n_slots` consecutive realtime slots chained in ONE device program.

    On a high-latency host<->device link every PJRT call blocks ~one round
    trip, so a per-slot dispatch can never beat a 21.3 ms slot budget when
    the round trip is longer, no matter how the copies overlap.
    Aggregating A slots amortizes the ~2-3
    blocking round trips per dispatch over A slots of audio; results
    surface up to A slots (~A*21 ms) later — a latency constant the
    reference's poll-based consumer surfaces already absorb (ref
    src/lib.rs:80-82; its UI reads asynchronously and every event is
    latency-compensated at stamp time).

    `host_vec` is the concatenation of the A per-slot `fused_slot_step`
    host vectors (each `[slot | gf_p | gf_o | hold | tick_sup(n_o)]`, with
    the per-slot gf/hold/tick values sampled by the host at THAT slot's
    callback — so per-slot AGC coupling is preserved exactly).  The body
    unrolls the single-slot step A times at trace time, chaining states,
    ring tails, and the onset->pitch pending flag on device; per-sub-slot
    tail lengths advance statically from (p_tail_len, o_tail_len).
    Returns the carries plus a TUPLE of A per-slot `FusedSlotOut`s — one
    deferred readback covers all A slots.  Semantics are those of A calls
    of `fused_slot_step`: the same traced ops in the same order, isolated
    per sub-step by optimization barriers.  Measured contract
    (tests/test_fused_streaming.py): all outputs (events, tracked pitches)
    and carries bit-equal to A separate dispatches EXCEPT the noise-floor
    IIR leaves (floor, volatility), which may carry ulp-relative (~1e-7)
    FMA-contraction drift — XLA may contract the EMA mul-adds differently
    in the chained module, the precision-only divergence class proven in
    tests/test_divergence_proof.py; self-limiting via the EMAs'
    forgetting."""
    outs = []
    off = 0
    p_len, o_len = p_tail_len, o_tail_len
    for _ in range(n_slots):
        n_p = num_frames(p_len + slot_len, p_window, p_hop)
        n_o = num_frames(o_len + slot_len, o_window, o_hop)
        # Barriers isolate each sub-step: without them XLA fuses across
        # the slot boundary (and into the host_vec slice) and may
        # re-contract FMAs differently than the compiled single-slot
        # program, leaving last-ulp drift in the floor state (observed on
        # CPU in the volatility EMA).  With them each sub-step compiles as
        # the same isolated unit the per-slot path runs — carries stay
        # bit-equal to A separate dispatches.
        sub = jax.lax.optimization_barrier(
            host_vec[off:off + slot_len + 3 + n_o])
        (nf_state, tr_state, onset_state, pending, p_tail, o_tail,
         out) = fused_slot_step(
            nf_state, tr_state, onset_state, pending, p_tail, o_tail, sub,
            sample_rate, slot_len, p_len, o_len, p_window, p_hop,
            o_window, o_hop, pitch_backend, onset_backend)
        (nf_state, tr_state, onset_state, pending, p_tail,
         o_tail) = jax.lax.optimization_barrier(
            (nf_state, tr_state, onset_state, pending, p_tail, o_tail))
        outs.append(out)
        off += slot_len + 3 + n_o
        p_len = p_len + slot_len - n_p * p_hop
        o_len = o_len + slot_len - n_o * o_hop
    return (nf_state, tr_state, onset_state, pending, p_tail, o_tail,
            pack_fused_out(tuple(outs)) if pack else tuple(outs))


@partial(jax.jit, static_argnames=("sample_rate", "slot_len", "n_slots",
                                   "p_tail_len", "o_tail_len", "p_window",
                                   "p_hop", "o_window", "o_hop",
                                   "pitch_backend", "onset_backend", "pack"))
def fused_slot_pool_step(states, host_vecs,
                         sample_rate: float, slot_len: int, n_slots: int,
                         p_tail_len: int, o_tail_len: int,
                         p_window: int = PITCH_WINDOW,
                         p_hop: int = PITCH_HOP, o_window: int = ONSET_WINDOW,
                         o_hop: int = ONSET_HOP,
                         pitch_backend: str = PITCH_BACKEND,
                         onset_backend: str = DEFAULT_BACKEND,
                         pack: bool = False):
    """One device program per slot WAVE: K live engines' fused slot steps
    batched (api/pool.EnginePool — the classroom scenario).

    `states` is a tuple over engines of the per-engine fused carries
    `(nf_state, tr_state, onset_state, pending, p_tail, o_tail)`;
    `host_vecs` is the [K, L] stack of the engines' host vectors — for
    `n_slots` > 1 each row is the concatenation of that engine's
    `n_slots` consecutive per-slot `fused_slot_step` host vectors (the
    `fused_slot_agg_step` layout), so one dispatch covers an
    aggregate-of-waves: K engines x A slots of audio with ~2 blocking
    link round trips total.  Inside the program the per-engine carries
    stack to a leading K axis, the (chained) single-engine step runs
    under `jax.vmap` (one batched program instead of K sequential
    dispatches), and the carries unstack back to per-engine pytrees — so
    between waves every engine still owns its own device arrays: an
    engine can leave the pool, checkpoint, or fall back to its
    single-engine path at any wave boundary with no repacking.  Outputs
    stay stacked over K ([n_slots tuple][K, ...]) for one deferred
    readback per dispatch (`pack=True`: ONE f32 vector, host-unpacked by
    `unpack_fused_pool_out`).

    Per-engine semantics are EXACTLY `fused_slot_agg_step`'s (vmap over
    independent rows; calibration hold is per-engine data in the host
    vector), with the same numeric contract: consumer-visible outputs
    bit-equal to per-engine dispatches, noise-floor IIR leaves allowed
    ulp-relative FMA-contraction drift (the batched module may contract
    the EMA mul-adds differently — tests/test_pool.py).  The reference
    can run one engine per process (ref src/audio_io/mod.rs:960-1129);
    this rebuild's qualitative win is K sessions per card in one
    dispatch."""
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    new_stacked, out = _pool_wave_stacked(
        stacked, host_vecs, sample_rate, slot_len, n_slots, p_tail_len,
        o_tail_len, p_window, p_hop, o_window, o_hop, pitch_backend,
        onset_backend, pack)
    new_states = tuple(
        jax.tree.map(lambda x: x[k], new_stacked)
        for k in range(len(states)))
    return new_states, out


def _pool_wave_stacked(stacked, host_vecs, sample_rate, slot_len, n_slots,
                       p_tail_len, o_tail_len, p_window, p_hop, o_window,
                       o_hop, pitch_backend, onset_backend, pack):
    """Shared trace of the pool wave over PRE-STACKED [K, ...] carries
    (the body of both fused_slot_pool_step and its mesh-shardable twin)."""
    nf, tr, os_, pend, pt, ot = stacked

    def one(nf, tr, os_, pend, pt, ot, hv):
        return fused_slot_agg_step(nf, tr, os_, pend, pt, ot, hv,
                                   sample_rate, slot_len, n_slots,
                                   p_tail_len, o_tail_len,
                                   p_window, p_hop, o_window, o_hop,
                                   pitch_backend, onset_backend)

    nf, tr, os_, pend, pt, ot, outs = jax.vmap(one)(
        nf, tr, os_, pend, pt, ot, host_vecs)
    return ((nf, tr, os_, pend, pt, ot),
            pack_fused_out(outs) if pack else outs)


@partial(jax.jit, static_argnames=("sample_rate", "slot_len", "n_slots",
                                   "p_tail_len", "o_tail_len", "p_window",
                                   "p_hop", "o_window", "o_hop",
                                   "pitch_backend", "onset_backend", "pack"))
def fused_slot_pool_step_stacked(stacked, host_vecs,
                                 sample_rate: float, slot_len: int,
                                 n_slots: int,
                                 p_tail_len: int, o_tail_len: int,
                                 p_window: int = PITCH_WINDOW,
                                 p_hop: int = PITCH_HOP,
                                 o_window: int = ONSET_WINDOW,
                                 o_hop: int = ONSET_HOP,
                                 pitch_backend: str = PITCH_BACKEND,
                                 onset_backend: str = DEFAULT_BACKEND,
                                 pack: bool = False):
    """`fused_slot_pool_step` over PRE-STACKED `[K, ...]` carries — the
    multi-chip classroom form.  The engine axis is a pure data-parallel
    vmap (lanes never communicate), so placing the stacked carries and
    `host_vecs` with a `NamedSharding` over a device mesh's axis
    partitions the wave across chips via XLA SPMD with zero collectives
    (computation follows data; see parallel/sharding.py
    make_pooled_wave_step and the multichip dryrun, which pins bitwise
    equality with the single-device pool step).  Returns
    (new_stacked, outs) with the same shardings."""
    return _pool_wave_stacked(
        stacked, host_vecs, sample_rate, slot_len, n_slots, p_tail_len,
        o_tail_len, p_window, p_hop, o_window, o_hop, pitch_backend,
        onset_backend, pack)


def unpack_fused_pool_out(vec: np.ndarray, n_engines: int,
                          frame_counts) -> list:
    """Host-side inverse of a packed `fused_slot_pool_step` readback.

    The packed vector is `pack_fused_out` over a tuple of `n_slots`
    FusedSlotOuts whose leaves carry a leading K (= n_engines) axis from
    the vmap — i.e. leaf-major, engine-minor.  `frame_counts` is the
    [(n_p, n_o)] list per chained sub-slot (shared by every engine in the
    wave: lockstep pooling implies identical ring-tail geometry).
    Returns outs[slot][engine] -> FusedSlotOut (tests/test_pool.py pins
    the round trip against the unpacked dispatch)."""
    vec = np.asarray(vec, np.float32)
    K = int(n_engines)
    off = 0

    def take(n, shape, dtype):
        nonlocal off
        part = vec[off:off + n]
        off += n
        part = part.reshape(shape)
        if dtype is bool:
            return part > 0.5
        return part.astype(dtype) if dtype is not np.float32 else part

    result = []
    for (n_p, n_o) in frame_counts:
        sf = take(K * n_p * 8, (K, n_p, 8), np.float32)
        ss = take(K * n_p * 8, (K, n_p, 8), np.float32)
        sv = take(K * n_p * 8, (K, n_p, 8), bool)
        o = [take(K * n_o, (K, n_o), d) for d in
             (bool, bool, np.float32, np.float32, np.float32, np.int32,
              bool, np.int32)]
        result.append([FusedSlotOut(sf[k], ss[k], sv[k],
                                    OnsetChunkOut(*(x[k] for x in o)))
                       for k in range(K)])
    return result


@dataclass
class OnsetAnalyzer:
    """Streaming onset detection (window 256 / hop 64)."""
    sample_rate: float
    window: int = ONSET_WINDOW
    hop: int = ONSET_HOP
    backend: str = DEFAULT_BACKEND
    # Bound per-call device memory (see PitchAnalyzer.max_chunk_frames);
    # onset arrays are only [n, 129] so the bound is far looser.
    max_chunk_frames: int = 131072
    _tail: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def __post_init__(self):
        self.state = onset_ops.init_state(self.window // 2 + 1)
        self.frames_consumed = 0

    def reset(self):
        self._tail = np.zeros(0, np.float32)
        self.state = onset_ops.init_state(self.window // 2 + 1)
        self.frames_consumed = 0

    def process(self, samples: np.ndarray, global_floor_db: float = -96.0,
                tick_suppressed: Optional[np.ndarray] = None,
                calibration_hold: bool = False):
        buf = np.concatenate([self._tail, np.asarray(samples, np.float32)])
        n = num_frames(len(buf), self.window, self.hop)
        if n == 0:
            self._tail = buf
            return None
        consumed = n * self.hop
        self._tail = buf[consumed:]
        half = self.window // 2 + 1
        gf_lin = float(noisefloor.global_floor_linear(global_floor_db, half))
        ts = (np.zeros(n, bool) if tick_suppressed is None
              else np.asarray(tick_suppressed, bool)[:n])
        buf_dev = jnp.asarray(buf)
        outs = []
        for c0 in range(0, n, self.max_chunk_frames):
            c1 = min(c0 + self.max_chunk_frames, n)
            sl = buf_dev[c0 * self.hop:(c1 - 1) * self.hop + self.window]
            frames = frame_signal(sl, self.window, self.hop)
            gf = jnp.full(c1 - c0, gf_lin, jnp.float32)
            ch = jnp.full((c1 - c0,), bool(calibration_hold))
            self.state, out = onset_analyze_frames(
                self.state, frames, gf, jnp.asarray(ts[c0:c1]),
                ch, self.window, self.backend)
            outs.append(out)
        out = outs[0] if len(outs) == 1 else jax.tree.map(
            lambda *xs: jnp.concatenate(xs), *outs)
        self.frames_consumed += n
        # Batched readback (see PitchAnalyzer.process): ~1 round trip, not 8.
        return jax.device_get(out)
