"""Segment-parallel offline analysis of one long recording.

The pitch pipeline's sequential state (per-bin noise floor, tracker) limits
single-stream throughput to the scan rate.  For *offline* analysis the
recording is split into S contiguous segments analyzed in parallel (vmap),
where every segment except the first warms its carried state on
`warmup_frames` of look-back audio whose outputs are discarded.  The floor
IIRs converge with time constants of ~25-50 frames (alphas 0.04/0.35/0.02,
ref stft.rs:219-225) and the tracker within 3 frames (max life), so a
128-frame (~1.5 s) warmup makes segment outputs match the exact sequential
run except for rare borderline peaks sitting right at the floor threshold.
The default was swept on the 1 h mixed scene (tools/warmup_sweep.py):
128 is the smallest value with 100.0000% frame agreement vs the exact
sequential run (64 and 96 each flip one frame in 310k — a floor-threshold-
proximal peak, consistent with the ~50-frame slowest IIR still settling);
256 buys nothing further while doubling the discarded-warmup overhead
(128 segments x 256 frames = 10.6% of a 1 h file vs 5.3% at 128).
Segment 0 starts from the fresh state — its outputs match the sequential
run: bit-identically with the "fft" backend (per-row-deterministic FFT),
and to within the GEMM's ~1e-6-relative batch-tiling rounding with the
banded-rDFT default (ops.stft.PITCH_BACKEND — XLA may tile the dot
differently for different chunk geometries, shifting per-row rounding).

The default geometry (128 segments x 64-frame chunks) is carried over
from an earlier build and not re-swept on the H100 yet (ROADMAP 1.5).  chip_smoke.py
phase 2 gates the frame agreement of a 1 h scene against the sequential
run on the card.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import noisefloor, onset as onset_ops, tracker
from ..ops.stft import (DEFAULT_BACKEND, ONSET_HOP, ONSET_WINDOW,
                        PITCH_BACKEND, PITCH_HOP, PITCH_WINDOW)
from ..utils.framing import frame_signal, num_frames
from .analyzer import onset_analyze_frames, pitch_extract_frames

DEFAULT_WARMUP_FRAMES = 128

# transfer="auto" crossover: the pipelined pitch path wins once the
# recording is long enough that the resident path's single monolithic
# device_put stalls the pipeline.  Onset compute is too cheap to hide
# uploads behind, so for onsets pipelined mode only pays its ~27%
# chunk-rounding duplicate bytes — auto always resolves to resident there.
#
# The 900 s crossover was set for a slow host<->device link; over PCIe
# resident may win at any length.  Not measured on the
# H100 (ROADMAP 1.5).  Both modes are result-identical, so a wrong pick
# only costs wall-clock; pass transfer= explicitly to override.
AUTO_PIPELINED_MIN_SECONDS = 900.0

_TRANSFER_MODES = ("auto", "resident", "pipelined")


def _resolve_transfer(transfer: str, kind: str, n_samples: int,
                      sample_rate: float, device_audio) -> str:
    """Resolve transfer="auto" to "resident" or "pipelined" (see
    AUTO_PIPELINED_MIN_SECONDS).  `kind` is "pitch" or "onset"."""
    if transfer not in _TRANSFER_MODES:
        raise ValueError(
            f"transfer={transfer!r}: expected one of {_TRANSFER_MODES}")
    if transfer != "auto":
        return transfer
    if device_audio is not None or kind == "onset":
        return "resident"
    long_enough = n_samples >= AUTO_PIPELINED_MIN_SECONDS * sample_rate
    return "pipelined" if long_enough else "resident"


class LeanPitchOut(NamedTuple):
    """Per-step outputs the segmented path actually consumes.

    `pitch_analyze_frames` also returns raw pitches, magnitudes and the
    effective floor; returning them from the jitted step would force XLA to
    materialize a [S, chunk, half] float32 output buffer per step (~33 MB at
    128x64) that nothing reads — dropping them here lets XLA DCE the output
    copies and keeps per-step live HBM to the stable pitch tensors only."""
    stable_freqs: jax.Array   # [S, chunk, 8]
    stable_scores: jax.Array  # [S, chunk, 8]
    stable_valid: jax.Array   # [S, chunk, 8]
# Onset state converges much faster than the pitch floor (flux/energy EMAs
# with per-frame alphas 0.84-0.89, TC < 10 frames; rise-once burst floors),
# and frames are much shorter (hop 64 ≈ 1.45 ms, so 128 frames ≈ 0.19 s).
# Swept on the 1 h mixed scene (tools/warmup_sweep.py): 128 already gives
# 100.0000% frame agreement with identical onset sets (3305/3305, zero
# shift); 256/384/512 buy nothing further.
DEFAULT_ONSET_WARMUP_FRAMES = 128


def _chunks_to_f32(audio_chunks):
    """int16 chunks convert on device by the exact power-of-two scale
    (see _upload_f32); float32 passes through."""
    if audio_chunks.dtype == jnp.int16:
        return audio_chunks.astype(jnp.float32) * np.float32(1.0 / 32768.0)
    return audio_chunks


@partial(jax.jit, static_argnames=("sample_rate", "window", "hop", "backend",
                                   "mesh"))
def _vmapped_step(nf_states, tr_states, audio_chunks, global_floor, onsets,
                  sample_rate: float, window: int, hop: int,
                  backend: str = PITCH_BACKEND, mesh=None):
    # Frame-parallel stages per segment under vmap; the tracker scan runs
    # batched OUTSIDE the vmap (one Pallas kernel on the GPU, the vmapped
    # XLA scan elsewhere — tracker.tracker_scan_batched).
    audio_chunks = _chunks_to_f32(audio_chunks)
    def one(nf, audio, gf):
        frames = frame_signal(audio, window, hop)
        nf, pf, _, _ = pitch_extract_frames(nf, frames, gf, sample_rate,
                                            window, hop, backend)
        return nf, pf
    nf_states, pf = jax.vmap(one)(nf_states, audio_chunks, global_floor)
    tr_states, (sf, ss, sv) = tracker.tracker_scan_batched(
        tr_states, pf.freqs, pf.scores, pf.valid, onsets, mesh=mesh)
    return nf_states, tr_states, LeanPitchOut(sf, ss, sv)


@partial(jax.jit, static_argnames=("stream_samples",))
def _slice_streams(audio_dev, stream_starts, stream_samples: int):
    """[S] sample offsets into the padded recording → [S, stream_samples]
    per-segment streams, device-resident.  One-time setup per analysis."""
    return jax.vmap(
        lambda s: jax.lax.dynamic_slice(audio_dev, (s,), (stream_samples,))
    )(stream_starts)


@partial(jax.jit, static_argnames=("chunk_samples", "sample_rate", "window",
                                   "hop", "backend", "mesh"))
def _vmapped_step_resident(nf_states, tr_states, seg_streams, offset,
                           global_floor, onsets, chunk_samples: int,
                           sample_rate: float, window: int, hop: int,
                           backend: str, mesh=None):
    """Device-resident step: all segment streams live on the device as one
    [S, T] array; each step slices every row at a COMMON scalar offset.
    This avoids both re-uploading ~segments * chunk_samples floats per step
    (which dominates wall-clock on a slow host<->device link) and per-row
    traced start indices (which defeat XLA's strided-slice lowering of the
    downstream framing gather)."""
    chunks = jax.lax.dynamic_slice(
        seg_streams, (0, offset), (seg_streams.shape[0], chunk_samples))

    def one(nf, audio, gf):
        frames = frame_signal(audio, window, hop)
        nf, pf, _, _ = pitch_extract_frames(nf, frames, gf, sample_rate,
                                            window, hop, backend)
        return nf, pf
    nf_states, pf = jax.vmap(one)(nf_states, chunks, global_floor)
    tr_states, (sf, ss, sv) = tracker.tracker_scan_batched(
        tr_states, pf.freqs, pf.scores, pf.valid, onsets, mesh=mesh)
    return nf_states, tr_states, LeanPitchOut(sf, ss, sv)


def _as_host_audio(audio: np.ndarray) -> np.ndarray:
    """float32 passthrough; int16 kept raw for the half-bandwidth upload."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = audio.astype(np.float32, copy=False)
    return audio


def _upload_f32(padded: np.ndarray):
    """Host audio → float32 device array.

    int16 uploads raw and converts on device — half the host→device bytes,
    which can dominate end to end for long recordings.  The
    conversion (x / 32768, a power of two) is exact, so results are
    bit-identical to converting on host first (utils.wav's scaling)."""
    dev = jnp.asarray(padded)
    if padded.dtype == np.int16:
        dev = dev.astype(jnp.float32) * np.float32(1.0 / 32768.0)
    return dev


def _snap_to_mesh(segments: int, mesh) -> int:
    """Sharding needs the segment axis divisible by the mesh; snap down
    (at minimum one segment per device)."""
    if mesh is None:
        return segments
    return max((segments // mesh.size) * mesh.size, mesh.size)


def _shard_batch(tree, mesh):
    """Shard every leaf's leading (segment) axis across a 1-D mesh."""
    from ..parallel.mesh import batch_sharding
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)


def _pipelined_blocks(padded: np.ndarray, stream_start: np.ndarray,
                      steps: int, chunk_frames: int, hop: int,
                      chunk_samples: int, mesh):
    """Double-buffered host→device feed: yields the device block for each
    step while the NEXT step's transfer is already in flight.

    The resident path uploads the whole recording before any compute; on a
    slow host↔device link the first math starts late.  Here each step's [S, chunk]
    block is gathered on host (int16 stays int16 — half the bytes; device
    converts) and device_put'd one step ahead, so transfer k+1 overlaps
    compute k and the pipeline starts after one block instead of the whole
    file.  Costs ~6% duplicate bytes (warmup overlap + window tails)."""
    sharding = None
    if mesh is not None:
        from ..parallel.mesh import batch_sharding
        sharding = batch_sharding(mesh)

    def put(block):
        return (jax.device_put(block, sharding) if sharding is not None
                else jax.device_put(block))

    base = stream_start * hop

    def host_block(k):
        off = base + k * chunk_frames * hop
        return np.stack([padded[o:o + chunk_samples] for o in off])

    pending = put(host_block(0))
    for k in range(steps):
        nxt = put(host_block(k + 1)) if k + 1 < steps else None
        yield pending
        pending = nxt


class _StreamPlan(NamedTuple):
    """Shared warmup-overlap stream geometry (see the module docstring).

    Every segment's stream is `stream_len = warmup + payload` frames;
    segment 0's whole stream is payload (fresh state — exact semantics),
    segments 1.. discard the first `warmup` outputs.  Payload split:
      seg 0 owns frames [0, stream_len); seg s>=1 owns
      [stream_len + (s-1)*payload, stream_len + s*payload).
    """
    segments: int
    warmup_frames: int
    payload: int        # payload frames per segment (chunk multiple)
    stream_len: int     # frames per stream incl. warmup
    steps: int          # jitted steps per stream
    stream_start: np.ndarray  # [S] stream start offsets, in FRAMES
    chunk_samples: int
    stream_samples: int
    max_sample: int     # samples a recording must be padded to

    def payload_range(self, s: int, n_total: int) -> tuple[int, int]:
        """Frame range [lo, hi) of the recording that segment s owns,
        clipped to the recording's own n_total."""
        if s == 0:
            return 0, min(self.stream_len, n_total)
        lo = self.stream_len + (s - 1) * self.payload
        return lo, min(lo + self.payload, n_total)


def _plan_streams(n_total: int, segments: int, warmup_frames: int,
                  chunk_frames: int, window: int, hop: int) -> _StreamPlan:
    payload = -(-max(n_total - warmup_frames, 1) // segments)
    payload = -(-payload // chunk_frames) * chunk_frames   # chunk multiple
    stream_len = warmup_frames + payload
    steps = -(-stream_len // chunk_frames)
    stream_start = np.array(
        [0] + [stream_len + (s - 1) * payload - warmup_frames
               for s in range(1, segments)])
    assert (stream_start >= 0).all()
    chunk_samples = (chunk_frames - 1) * hop + window
    stream_samples = (steps - 1) * chunk_frames * hop + chunk_samples
    max_sample = int(stream_start.max()) * hop + stream_samples
    return _StreamPlan(segments, warmup_frames, payload, stream_len, steps,
                       stream_start, chunk_samples, stream_samples,
                       max_sample)


def auto_segments(n_total: int, warmup_frames: int, cap: int = 128) -> int:
    """Segment count for a recording of n_total frames: keep each segment's
    payload near >= 10x the discarded warmup (overhead ~<= 10%), capped
    at 128, a value carried over from an earlier build (not re-swept on
    the H100; tools/segment_sweep.py measures it).  Snapped to a power of
    two: each distinct (segments, chunk) pair is its own XLA program, and
    pow2 counts bound the compile-cache population at ~8 entries."""
    ideal = min(cap, n_total // (warmup_frames * 10))
    if ideal <= 1:
        return 1
    lower = 1 << (ideal.bit_length() - 1)
    upper = min(lower * 2, cap)
    return upper if ideal >= lower + lower // 2 else lower


def segmented_pitch_analysis(audio: np.ndarray, sample_rate: float,
                             segments: int | None = None,
                             warmup_frames: int = DEFAULT_WARMUP_FRAMES,
                             chunk_frames: int = 64,
                             window: int = PITCH_WINDOW,
                             hop: int = PITCH_HOP,
                             backend: str = PITCH_BACKEND,
                             global_floor_db: float = -96.0,
                             mesh=None, device_audio=None,
                             transfer: str = "auto",
                             warmup_mode: str = "full"):
    """Analyze one long mono buffer with S parallel segments.

    Returns (stable_freqs [N,8], stable_scores [N,8], stable_valid [N,8])
    covering all N frames of the recording, in order.

    `segments=None` (default) picks the count adaptively via
    `auto_segments` — hour-scale audio fans out to 128 parallel scan
    streams; short clips fall back toward exact sequential analysis.

    With `mesh` (a 1-D jax.sharding.Mesh) the segment axis is sharded
    across its devices — one recording fans out over the whole chip fleet
    (segments should be a multiple of the device count); jit partitions the
    vmapped step SPMD with no cross-device collectives on the hot path.

    `transfer`: "resident" uploads the recording once and slices on device
    (best when the upload is shared with other analyses via
    `device_audio`); "pipelined" double-buffers per-step host→device blocks
    so transfers overlap compute and the first math starts after one block
    (best for a single analysis over a slow link — see _pipelined_blocks).
    "auto" (default) picks by the measured crossover: pipelined for a
    standalone analysis of >= AUTO_PIPELINED_MIN_SECONDS of audio,
    resident otherwise.  Results are identical.

    `warmup_mode`: "full" (default) runs the complete pipeline on every
    discarded look-back frame; "floor" seeds the floor IIR with a
    comb-free STFT+floor pass and re-warms only the tracker on the last
    TRACKER_REWARM_FRAMES look-back frames — reclaiming most of the ~5%
    discarded-warmup compute (see _segmented_pitch_floor_warmup; gated on
    measured frame agreement, resident transfer only).
    """
    audio = _as_host_audio(audio)
    transfer = _resolve_transfer(transfer, "pitch", len(audio), sample_rate,
                                 device_audio)
    n_total = num_frames(len(audio), window, hop)
    if n_total <= 0:
        z = np.zeros((0, 8), np.float32)
        return z, z.copy(), np.zeros((0, 8), bool)
    if segments is None:
        segments = auto_segments(n_total, warmup_frames)
    if warmup_mode not in ("full", "floor"):
        raise ValueError(f"warmup_mode={warmup_mode!r}: expected 'full' or "
                         "'floor'")
    if warmup_mode == "floor":
        return _segmented_pitch_floor_warmup(
            audio, sample_rate, segments, warmup_frames, chunk_frames,
            window, hop, backend, global_floor_db, mesh, device_audio,
            n_total)

    # Stream geometry (see _StreamPlan; the module docstring covers the GEMM
    # backend's geometry-rounding caveat for segment 0's exact prefix).
    segments = max(1, min(segments, max(n_total // max(chunk_frames, 1), 1)))
    segments = _snap_to_mesh(segments, mesh)
    plan = _plan_streams(n_total, segments, warmup_frames, chunk_frames,
                         window, hop)
    steps, stream_start = plan.steps, plan.stream_start

    half = window // 2 + 1
    gf_lin = float(np.asarray(
        noisefloor.global_floor_linear(global_floor_db, half)))

    def rep(state):
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (segments,) + a.shape), state)
    nf_states = rep(noisefloor.init_state(half))
    tr_states = rep(tracker.init_state())

    chunk_samples, stream_samples = plan.chunk_samples, plan.stream_samples
    max_sample = plan.max_sample

    out_freqs = np.zeros((n_total, 8), np.float32)
    out_scores = np.zeros((n_total, 8), np.float32)
    out_valid = np.zeros((n_total, 8), bool)

    gf = jnp.full((segments, chunk_frames), gf_lin, jnp.float32)
    onsets = jnp.zeros((segments, chunk_frames), bool)
    if mesh is not None:
        nf_states, tr_states, gf, onsets = _shard_batch(
            (nf_states, tr_states, gf, onsets), mesh)

    # All steps are queued back-to-back with outputs kept device-resident;
    # one readback at the end.  Per-step np.asarray would synchronize every
    # step and pay the host link round-trip `3 * steps` times.
    step_outs = []
    if transfer == "pipelined" and device_audio is None:
        padded = np.pad(audio, (0, max(0, max_sample - len(audio))))
        for chunk in _pipelined_blocks(padded, stream_start, steps,
                                       chunk_frames, hop, chunk_samples,
                                       mesh):
            nf_states, tr_states, out = _vmapped_step(
                nf_states, tr_states, chunk, gf, onsets, sample_rate,
                window, hop, backend, mesh)
            step_outs.append(out)
    else:
        if device_audio is not None:
            # Caller already uploaded the recording (float32, len(audio)
            # samples): pad on device instead of paying a second upload.
            audio_dev = jnp.pad(device_audio,
                                (0, max(0, max_sample - len(audio))))
        else:
            audio_dev = _upload_f32(
                np.pad(audio, (0, max(0, max_sample - len(audio)))))
        seg_streams = _slice_streams(
            audio_dev, jnp.asarray(stream_start * hop, jnp.int32),
            stream_samples)
        if mesh is not None:
            seg_streams = _shard_batch(seg_streams, mesh)
        for step in range(steps):
            nf_states, tr_states, out = _vmapped_step_resident(
                nf_states, tr_states, seg_streams,
                jnp.asarray(step * chunk_frames * hop, jnp.int32), gf,
                onsets, chunk_samples, sample_rate, window, hop, backend,
                mesh)
            step_outs.append(out)
    sf = np.asarray(jnp.stack([o.stable_freqs for o in step_outs], 1))
    ss = np.asarray(jnp.stack([o.stable_scores for o in step_outs], 1))
    sv = np.asarray(jnp.stack([o.stable_valid for o in step_outs], 1))
    # [S, steps, chunk, 8] → each segment's stream is contiguous over steps.
    sf = sf.reshape(segments, steps * chunk_frames, 8)
    ss = ss.reshape(segments, steps * chunk_frames, 8)
    sv = sv.reshape(segments, steps * chunk_frames, 8)
    for s in range(segments):
        pay_lo, pay_hi = plan.payload_range(s, n_total)
        if pay_lo >= pay_hi:
            continue
        src = pay_lo - stream_start[s]   # warmup offset within the stream
        out_freqs[pay_lo:pay_hi] = sf[s, src:src + (pay_hi - pay_lo)]
        out_scores[pay_lo:pay_hi] = ss[s, src:src + (pay_hi - pay_lo)]
        out_valid[pay_lo:pay_hi] = sv[s, src:src + (pay_hi - pay_lo)]
    return out_freqs, out_scores, out_valid


# Tracker re-warmup length for warmup_mode="floor": fresh tracker state
# converges to the sequential tracker's within ~30 frames (the freq/score
# EMAs forget at 0.6/frame -> 0.6^32 ~ 8e-8 relative; hysteresis absorbs
# the residual).  The floor IIR — the slow one (~50-frame release) — is
# seeded EXACTLY by running the real floor recurrence over the full
# look-back in phase 1, so only the tracker needs these full-pipeline
# frames.
TRACKER_REWARM_FRAMES = 32


@partial(jax.jit, static_argnames=("sample_rate", "window", "hop",
                                   "backend"))
def _vmapped_floor_warmup(nf_states, warm_streams, global_floor,
                          sample_rate: float, window: int, hop: int,
                          backend: str):
    """Phase 1 of warmup_mode='floor': per-segment STFT + floor scan over
    the look-back frames, comb/tracker skipped (analyzer.floor_warmup_frames
    under vmap)."""
    from .analyzer import floor_warmup_frames
    warm_streams = _chunks_to_f32(warm_streams)

    def one(nf, audio, gf):
        frames = frame_signal(audio, window, hop)
        return floor_warmup_frames(nf, frames, gf, sample_rate, window,
                                   backend)
    return jax.vmap(one)(nf_states, warm_streams, global_floor)


def _segmented_pitch_floor_warmup(audio, sample_rate, segments,
                                  warmup_frames, chunk_frames, window, hop,
                                  backend, global_floor_db, mesh,
                                  device_audio, n_total):
    """`segmented_pitch_analysis(warmup_mode="floor")`: two-phase warmup
    that skips the comb on most look-back frames.

    In "full" mode every segment's `warmup_frames` look-back runs the FULL
    pipeline and discards the outputs — but the comb/top-K stages may be
    most of the step cost (not measured on the H100) and only the
    floor IIR state is actually needed from the look-back.  Here:

      phase 1: the first `warmup_frames - TRACKER_REWARM_FRAMES` look-back
               frames run STFT + floor scan ONLY (floor state seeded by
               the REAL recurrence — not an estimate — so the slow IIR is
               converged the same way "full" converges it);
      phase 2: the remaining TRACKER_REWARM_FRAMES look-back frames plus
               the payload run the full pipeline with a fresh tracker
               (its EMAs forget at 0.6/frame, so 32 frames re-converge it).

    Stream geometry: every segment owns `payload2 = ceil-to-alignment`
    frames, with payload2 + TRACKER_REWARM_FRAMES an exact chunk multiple
    so phase 2 wastes zero overshoot frames; segment 0 (no look-back, by
    construction exact) starts its stream at frame 0 and owns the stream
    head.  Resident-transfer only (the pipelined feeder would need its own
    two-phase block schedule; pass transfer="resident"/"auto").

    Agreement vs "full": not bit-identical (phase 1 is a different XLA
    module, so FMA-contraction ulp drift of the divergence-proof class
    applies to the seeded floor state) — gated instead on measured frame
    agreement (tools/agreement_1h.py --warmup-mode floor;
    tests/test_segmented.py has the short-scene gate)."""
    tw = TRACKER_REWARM_FRAMES
    base = -(-n_total // segments)
    payload2 = -(-(base + tw) // chunk_frames) * chunk_frames - tw
    if payload2 < warmup_frames or segments == 1:
        # Segments too short for a full look-back (or nothing to warm):
        # the plain path's overhead is small exactly when this happens.
        return segmented_pitch_analysis(
            audio, sample_rate, segments, warmup_frames, chunk_frames,
            window, hop, backend, global_floor_db, mesh, device_audio,
            transfer="resident", warmup_mode="full")
    steps2 = (tw + payload2) // chunk_frames
    wf = warmup_frames - tw
    starts = np.array([0] + [s * payload2 - tw
                             for s in range(1, segments)])
    warm_starts = np.array([0] + [s * payload2 - warmup_frames
                                  for s in range(1, segments)])
    chunk_samples = (chunk_frames - 1) * hop + window
    stream_samples = (steps2 * chunk_frames - 1) * hop + window
    warm_samples = (wf - 1) * hop + window
    max_sample = int(starts.max()) * hop + stream_samples

    half = window // 2 + 1
    gf_lin = float(np.asarray(
        noisefloor.global_floor_linear(global_floor_db, half)))

    def rep(state):
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (segments,) + a.shape), state)
    nf_init = noisefloor.init_state(half)
    nf_states = rep(nf_init)
    tr_states = rep(tracker.init_state())

    if device_audio is not None:
        audio_dev = jnp.pad(device_audio,
                            (0, max(0, max_sample - len(audio))))
    else:
        audio_dev = _upload_f32(
            np.pad(audio, (0, max(0, max_sample - len(audio)))))

    gf_warm = jnp.full((segments, wf), gf_lin, jnp.float32)
    gf = jnp.full((segments, chunk_frames), gf_lin, jnp.float32)
    onsets = jnp.zeros((segments, chunk_frames), bool)
    warm_streams = _slice_streams(
        audio_dev, jnp.asarray(warm_starts * hop, jnp.int32), warm_samples)
    seg_streams = _slice_streams(
        audio_dev, jnp.asarray(starts * hop, jnp.int32), stream_samples)
    if mesh is not None:
        (nf_states, tr_states, gf_warm, gf, onsets, warm_streams,
         seg_streams) = _shard_batch(
            (nf_states, tr_states, gf_warm, gf, onsets, warm_streams,
             seg_streams), mesh)

    # Phase 1: comb-free floor seeding; segment 0's row ran on junk (its
    # stream has no look-back) — reset it to the fresh init state.
    nf_states = _vmapped_floor_warmup(nf_states, warm_streams, gf_warm,
                                      sample_rate, window, hop, backend)
    nf_states = jax.tree.map(lambda a, i: a.at[0].set(i), nf_states,
                             nf_init)

    # Phase 2: the full pipeline — the SAME [S, chunk] program "full" mode
    # compiles (cache hit), over tw + payload2 frames per segment.
    step_outs = []
    for step in range(steps2):
        nf_states, tr_states, out = _vmapped_step_resident(
            nf_states, tr_states, seg_streams,
            jnp.asarray(step * chunk_frames * hop, jnp.int32), gf,
            onsets, chunk_samples, sample_rate, window, hop, backend, mesh)
        step_outs.append(out)
    sf = np.asarray(jnp.stack([o.stable_freqs for o in step_outs], 1))
    ss = np.asarray(jnp.stack([o.stable_scores for o in step_outs], 1))
    sv = np.asarray(jnp.stack([o.stable_valid for o in step_outs], 1))
    sf = sf.reshape(segments, steps2 * chunk_frames, 8)
    ss = ss.reshape(segments, steps2 * chunk_frames, 8)
    sv = sv.reshape(segments, steps2 * chunk_frames, 8)

    out_freqs = np.zeros((n_total, 8), np.float32)
    out_scores = np.zeros((n_total, 8), np.float32)
    out_valid = np.zeros((n_total, 8), bool)
    for s in range(segments):
        lo = s * payload2
        hi = min(lo + payload2, n_total)
        if lo >= hi:
            continue
        src = 0 if s == 0 else tw
        out_freqs[lo:hi] = sf[s, src:src + (hi - lo)]
        out_scores[lo:hi] = ss[s, src:src + (hi - lo)]
        out_valid[lo:hi] = sv[s, src:src + (hi - lo)]
    return out_freqs, out_scores, out_valid


@partial(jax.jit, static_argnames=("window", "backend", "hop"))
def _vmapped_onset_chunks(states, chunks, global_floor, tick_sup, hold,
                          window: int, backend: str, hop: int):
    chunks = _chunks_to_f32(chunks)
    def one(st, audio, gf, ts, ch):
        frames = frame_signal(audio, window, hop)
        return onset_analyze_frames(st, frames, gf, ts, ch, window, backend)
    return jax.vmap(one)(states, chunks, global_floor, tick_sup, hold)


@partial(jax.jit, static_argnames=("chunk_samples", "window", "backend",
                                   "hop"))
def _vmapped_onset_step(states, seg_streams, offset, global_floor, tick_sup,
                        hold, chunk_samples: int, window: int, backend: str,
                        hop: int):
    chunks = jax.lax.dynamic_slice(
        seg_streams, (0, offset), (seg_streams.shape[0], chunk_samples))

    def one(st, audio, gf, ts, ch):
        frames = frame_signal(audio, window, hop)
        return onset_analyze_frames(st, frames, gf, ts, ch, window, backend)
    return jax.vmap(one)(states, chunks, global_floor, tick_sup, hold)


def segmented_onset_analysis(audio: np.ndarray, sample_rate: float,
                             segments: int | None = None,
                             warmup_frames: int = DEFAULT_ONSET_WARMUP_FRAMES,
                             chunk_frames: int = 4096,
                             window: int = ONSET_WINDOW,
                             hop: int = ONSET_HOP,
                             backend: str = DEFAULT_BACKEND,
                             global_floor_db: float = -96.0,
                             mesh=None, device_audio=None,
                             transfer: str = "auto"):
    """Segment-parallel offline onset detection over one long mono buffer.

    Same warmup-overlap scheme as `segmented_pitch_analysis`; segment 0 is
    bit-identical to the sequential run.  Returns
    (fired [N] bool, velocity [N] f32, flux [N] f32, energy [N] f32)
    for all N = num_frames(len(audio)) onset frames, in order.
    With `mesh`, segments shard across the device fleet; `transfer` as in
    segmented_pitch_analysis ("pipelined" overlaps per-step uploads with
    compute; "auto" — the default — resolves to "resident" for onsets,
    whose device compute is too cheap to hide uploads behind).
    """
    audio = _as_host_audio(audio)
    transfer = _resolve_transfer(transfer, "onset", len(audio), sample_rate,
                                 device_audio)
    n_total = num_frames(len(audio), window, hop)
    if n_total <= 0:
        z = np.zeros(0, np.float32)
        return np.zeros(0, bool), z, z.copy(), z.copy()
    if segments is None:
        segments = auto_segments(n_total, warmup_frames)

    segments = max(1, min(segments, max(n_total // max(chunk_frames, 1), 1)))
    segments = _snap_to_mesh(segments, mesh)
    plan = _plan_streams(n_total, segments, warmup_frames, chunk_frames,
                         window, hop)
    steps, stream_start = plan.steps, plan.stream_start

    half = window // 2 + 1
    gf_lin = float(np.asarray(
        noisefloor.global_floor_linear(global_floor_db, half)))

    states = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (segments,) + a.shape),
        onset_ops.init_state(half))

    chunk_samples, stream_samples = plan.chunk_samples, plan.stream_samples
    max_sample = plan.max_sample

    out_fired = np.zeros(n_total, bool)
    out_vel = np.zeros(n_total, np.float32)
    out_flux = np.zeros(n_total, np.float32)
    out_energy = np.zeros(n_total, np.float32)

    gf = jnp.full((segments, chunk_frames), gf_lin, jnp.float32)
    ts = jnp.zeros((segments, chunk_frames), bool)
    hold = jnp.zeros((segments, chunk_frames), bool)
    if mesh is not None:
        states, gf, ts, hold = _shard_batch((states, gf, ts, hold), mesh)

    step_outs = []
    if transfer == "pipelined" and device_audio is None:
        padded = np.pad(audio, (0, max(0, max_sample - len(audio))))
        for chunk in _pipelined_blocks(padded, stream_start, steps,
                                       chunk_frames, hop, chunk_samples,
                                       mesh):
            states, out = _vmapped_onset_chunks(states, chunk, gf, ts, hold,
                                                window, backend, hop)
            step_outs.append(out)
    else:
        if device_audio is not None:
            # Caller already uploaded the recording (float32, len(audio)
            # samples): pad on device instead of paying a second upload.
            audio_dev = jnp.pad(device_audio,
                                (0, max(0, max_sample - len(audio))))
        else:
            audio_dev = _upload_f32(
                np.pad(audio, (0, max(0, max_sample - len(audio)))))
        seg_streams = _slice_streams(
            audio_dev, jnp.asarray(stream_start * hop, jnp.int32),
            stream_samples)
        if mesh is not None:
            seg_streams = _shard_batch(seg_streams, mesh)
        for step in range(steps):
            states, out = _vmapped_onset_step(
                states, seg_streams, jnp.asarray(step * chunk_frames * hop,
                                                 jnp.int32), gf, ts, hold,
                chunk_samples, window, backend, hop)
            step_outs.append(out)
    fired = np.asarray(jnp.stack([o.fired for o in step_outs], 1)) \
        .reshape(segments, steps * chunk_frames)
    vel = np.asarray(jnp.stack([o.velocity for o in step_outs], 1)) \
        .reshape(segments, steps * chunk_frames)
    flux = np.asarray(jnp.stack([o.flux for o in step_outs], 1)) \
        .reshape(segments, steps * chunk_frames)
    energy = np.asarray(jnp.stack([o.energy for o in step_outs], 1)) \
        .reshape(segments, steps * chunk_frames)
    for s in range(segments):
        pay_lo, pay_hi = plan.payload_range(s, n_total)
        if pay_lo >= pay_hi:
            continue
        src = pay_lo - stream_start[s]
        out_fired[pay_lo:pay_hi] = fired[s, src:src + (pay_hi - pay_lo)]
        out_vel[pay_lo:pay_hi] = vel[s, src:src + (pay_hi - pay_lo)]
        out_flux[pay_lo:pay_hi] = flux[s, src:src + (pay_hi - pay_lo)]
        out_energy[pay_lo:pay_hi] = energy[s, src:src + (pay_hi - pay_lo)]
    return out_fired, out_vel, out_flux, out_energy


# ── Batched multi-recording analysis (serving many short takes) ──────────
#
# A single short take (a ~30 s practice recording — the reference app's
# actual workload, ref src/practice/mod.rs:430-560 sessions) only fans out
# to a handful of segments (auto_segments: payload >= 10x warmup), so one
# take leaves the card mostly idle: ~2 scan streams against the 128-row
# geometry the step is sized for.  For
# serving, the fix is batching RECORDINGS x SEGMENTS as one flat row axis:
# every row is an independent scan stream (fresh state, own warmup), so B
# takes x S segments reuse the exact single-recording step programs
# (_vmapped_step_resident) at full occupancy.  Rows of different takes
# never interact; each take unpacks exactly like the single-recording path.


def _pow2_floor(v: int) -> int:
    return 1 << (max(int(v), 1).bit_length() - 1)


def _batch_plan(n_list, segments_per_recording, warmup_frames, chunk_frames,
                window, hop, rows_target: int = 128):
    """Shared geometry for a batch: every recording gets the same
    segments-per-recording S and the same stream plan (sized for the
    longest recording; shorter ones zero-pad and clip at unpack).  S is
    picked so B*S lands near `rows_target` (the segmented step's 128-row
    geometry) without exceeding auto_segments' payload>=10x-warmup rule."""
    n_max = max(n_list)
    if segments_per_recording is None:
        cap = _pow2_floor(max(1, rows_target // max(len(n_list), 1)))
        segments_per_recording = auto_segments(n_max, warmup_frames, cap=cap)
    s = max(1, min(segments_per_recording,
                   max(n_max // max(chunk_frames, 1), 1)))
    return _plan_streams(n_max, s, warmup_frames, chunk_frames, window, hop)


def _pack_batch(hosts, plan, hop, mesh):
    """Recordings → one flat device-upload array + per-row slice starts.

    Each recording is zero-padded to `plan.max_sample` and laid out
    contiguously, so row (b, s) slices at b*max_sample + stream_start[s]*hop
    and never crosses into recording b+1.  int16 stays int16 for the
    half-bandwidth upload iff ALL recordings are int16 (mixed batches
    convert to f32 on host).  With `mesh`, rows pad up to a device-count
    multiple with dummy rows (start 0; outputs discarded)."""
    b = len(hosts)
    dtype = np.int16 if all(h.dtype == np.int16 for h in hosts) \
        else np.float32
    flat = np.zeros(b * plan.max_sample, dtype)
    for i, h in enumerate(hosts):
        flat[i * plan.max_sample:i * plan.max_sample + len(h)] = \
            h if h.dtype == dtype else h.astype(np.float32)
    rows = b * plan.segments
    rows_pad = rows if mesh is None else \
        -(-rows // mesh.size) * mesh.size
    starts = np.zeros(rows_pad, np.int64)
    for r in range(rows):
        rec, s = divmod(r, plan.segments)
        starts[r] = rec * plan.max_sample + int(plan.stream_start[s]) * hop
    return flat, jnp.asarray(starts, jnp.int32), rows_pad


def segmented_pitch_analysis_batch(audios, sample_rate: float,
                                   segments_per_recording: int | None = None,
                                   warmup_frames: int = DEFAULT_WARMUP_FRAMES,
                                   chunk_frames: int = 64,
                                   window: int = PITCH_WINDOW,
                                   hop: int = PITCH_HOP,
                                   backend: str = PITCH_BACKEND,
                                   global_floor_db: float = -96.0,
                                   mesh=None):
    """Analyze a BATCH of independent mono recordings in one device program.

    Returns a list of (stable_freqs [Ni,8], stable_scores [Ni,8],
    stable_valid [Ni,8]) — exactly `segmented_pitch_analysis`'s contract,
    per recording.  Recordings may have different lengths (each is padded
    to the longest; outputs clip to its own frame count) and int16 input
    keeps the half-bandwidth upload when the whole batch is int16.

    With `mesh`, the flat recording×segment row axis shards across the
    devices (rows pad up to a device-count multiple).
    """
    hosts = [_as_host_audio(a) for a in audios]
    if not hosts:
        return []
    n_list = [num_frames(len(h), window, hop) for h in hosts]
    empty = (np.zeros((0, 8), np.float32), np.zeros((0, 8), np.float32),
             np.zeros((0, 8), bool))
    if max(n_list) <= 0:
        return [empty for _ in hosts]
    plan = _batch_plan(n_list, segments_per_recording, warmup_frames,
                       chunk_frames, window, hop)
    flat, starts, rows = _pack_batch(hosts, plan, hop, mesh)

    half = window // 2 + 1
    gf_lin = float(np.asarray(
        noisefloor.global_floor_linear(global_floor_db, half)))

    def rep(state):
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (rows,) + a.shape), state)
    nf_states = rep(noisefloor.init_state(half))
    tr_states = rep(tracker.init_state())
    gf = jnp.full((rows, chunk_frames), gf_lin, jnp.float32)
    onsets = jnp.zeros((rows, chunk_frames), bool)

    audio_dev = _upload_f32(flat)
    seg_streams = _slice_streams(audio_dev, starts, plan.stream_samples)
    if mesh is not None:
        nf_states, tr_states, gf, onsets, seg_streams = _shard_batch(
            (nf_states, tr_states, gf, onsets, seg_streams), mesh)

    step_outs = []
    for step in range(plan.steps):
        nf_states, tr_states, out = _vmapped_step_resident(
            nf_states, tr_states, seg_streams,
            jnp.asarray(step * chunk_frames * hop, jnp.int32), gf, onsets,
            plan.chunk_samples, sample_rate, window, hop, backend, mesh)
        step_outs.append(out)
    sf = np.asarray(jnp.stack([o.stable_freqs for o in step_outs], 1))
    ss = np.asarray(jnp.stack([o.stable_scores for o in step_outs], 1))
    sv = np.asarray(jnp.stack([o.stable_valid for o in step_outs], 1))
    stream_frames = plan.steps * chunk_frames
    sf = sf.reshape(rows, stream_frames, 8)
    ss = ss.reshape(rows, stream_frames, 8)
    sv = sv.reshape(rows, stream_frames, 8)

    results = []
    for b, n_total in enumerate(n_list):
        of = np.zeros((n_total, 8), np.float32)
        os_ = np.zeros((n_total, 8), np.float32)
        ov = np.zeros((n_total, 8), bool)
        for s in range(plan.segments):
            pay_lo, pay_hi = plan.payload_range(s, n_total)
            if pay_lo >= pay_hi:
                continue
            r = b * plan.segments + s
            src = pay_lo - int(plan.stream_start[s])
            of[pay_lo:pay_hi] = sf[r, src:src + (pay_hi - pay_lo)]
            os_[pay_lo:pay_hi] = ss[r, src:src + (pay_hi - pay_lo)]
            ov[pay_lo:pay_hi] = sv[r, src:src + (pay_hi - pay_lo)]
        results.append((of, os_, ov))
    return results


def segmented_onset_analysis_batch(audios, sample_rate: float,
                                   segments_per_recording: int | None = None,
                                   warmup_frames: int =
                                   DEFAULT_ONSET_WARMUP_FRAMES,
                                   chunk_frames: int = 4096,
                                   window: int = ONSET_WINDOW,
                                   hop: int = ONSET_HOP,
                                   backend: str = DEFAULT_BACKEND,
                                   global_floor_db: float = -96.0,
                                   mesh=None):
    """Batch analog of `segmented_onset_analysis`: a list of recordings in,
    a list of (fired [Ni], velocity [Ni], flux [Ni], energy [Ni]) out —
    one device program over the flat recording×segment row axis (see
    `segmented_pitch_analysis_batch`)."""
    hosts = [_as_host_audio(a) for a in audios]
    if not hosts:
        return []
    n_list = [num_frames(len(h), window, hop) for h in hosts]
    z = np.zeros(0, np.float32)
    empty = (np.zeros(0, bool), z, z.copy(), z.copy())
    if max(n_list) <= 0:
        return [empty for _ in hosts]
    plan = _batch_plan(n_list, segments_per_recording, warmup_frames,
                       chunk_frames, window, hop)
    flat, starts, rows = _pack_batch(hosts, plan, hop, mesh)

    half = window // 2 + 1
    gf_lin = float(np.asarray(
        noisefloor.global_floor_linear(global_floor_db, half)))
    states = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (rows,) + a.shape),
        onset_ops.init_state(half))
    gf = jnp.full((rows, chunk_frames), gf_lin, jnp.float32)
    ts = jnp.zeros((rows, chunk_frames), bool)
    hold = jnp.zeros((rows, chunk_frames), bool)

    audio_dev = _upload_f32(flat)
    seg_streams = _slice_streams(audio_dev, starts, plan.stream_samples)
    if mesh is not None:
        states, gf, ts, hold, seg_streams = _shard_batch(
            (states, gf, ts, hold, seg_streams), mesh)

    step_outs = []
    for step in range(plan.steps):
        states, out = _vmapped_onset_step(
            states, seg_streams,
            jnp.asarray(step * chunk_frames * hop, jnp.int32), gf, ts, hold,
            plan.chunk_samples, window, backend, hop)
        step_outs.append(out)
    stream_frames = plan.steps * chunk_frames
    fired = np.asarray(jnp.stack([o.fired for o in step_outs], 1)) \
        .reshape(rows, stream_frames)
    vel = np.asarray(jnp.stack([o.velocity for o in step_outs], 1)) \
        .reshape(rows, stream_frames)
    flux = np.asarray(jnp.stack([o.flux for o in step_outs], 1)) \
        .reshape(rows, stream_frames)
    energy = np.asarray(jnp.stack([o.energy for o in step_outs], 1)) \
        .reshape(rows, stream_frames)

    results = []
    for b, n_total in enumerate(n_list):
        o_f = np.zeros(n_total, bool)
        o_v = np.zeros(n_total, np.float32)
        o_x = np.zeros(n_total, np.float32)
        o_e = np.zeros(n_total, np.float32)
        for s in range(plan.segments):
            pay_lo, pay_hi = plan.payload_range(s, n_total)
            if pay_lo >= pay_hi:
                continue
            r = b * plan.segments + s
            src = pay_lo - int(plan.stream_start[s])
            o_f[pay_lo:pay_hi] = fired[r, src:src + (pay_hi - pay_lo)]
            o_v[pay_lo:pay_hi] = vel[r, src:src + (pay_hi - pay_lo)]
            o_x[pay_lo:pay_hi] = flux[r, src:src + (pay_hi - pay_lo)]
            o_e[pay_lo:pay_hi] = energy[r, src:src + (pay_hi - pay_lo)]
        results.append((o_f, o_v, o_x, o_e))
    return results
