"""Input conditioning: biquad HPF/LPF + envelope-follower noise gate.

Port of the reducer thread's per-sample loop (ref src/audio_io/mod.rs:336-511):
RBJ biquads (HPF 40 Hz, LPF 14 kHz, Q=0.707), instantaneous-attack envelope
follower with 40 ms release and 20 ms hold, gate gain ratio^4 below the
-60 dB threshold.

Device structure: the biquads are 2nd-order linear recurrences →
`lax.associative_scan` over 2x2 companion-matrix products (log-depth, in
parallel) instead of a 48k-step sequential loop.  The gate's
envelope follower (max with decaying EMA + hold counter) is genuinely
nonlinear-sequential, but it is *blockwise* parallelizable: we scan over
slots (1024 samples) with an inner `lax.scan` — this stays the parity path.
A bit-exact C++ host implementation lives in runtime/ for the streaming
engine (the reference runs this on a dedicated CPU thread too).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

GATE_THRESHOLD_DB = -60.0
GATE_RELEASE_S = 0.040
GATE_HOLD_S = 0.020
HPF_FREQ = 40.0
LPF_FREQ = 14000.0


def biquad_coeffs(freq: float, sample_rate: float, is_lpf: bool):
    """RBJ biquad with Q=0.707, normalized (ref mod.rs:351-377), float32.

    Divergence: the reference computes coefficients for any cutoff, so at
    device rates below 2*LPF_FREQ=28 kHz (e.g. 22.05 kHz) its 14 kHz lowpass
    has poles outside the unit circle and the whole pipeline NaNs out.  We
    clamp the cutoff to 0.45*fs — a no-op at every standard rate >= 32 kHz.
    """
    f32 = np.float32
    freq = min(float(freq), 0.45 * float(sample_rate))
    w0 = f32(2.0) * f32(np.pi) * f32(freq) / f32(sample_rate)
    cos_w0, sin_w0 = f32(np.cos(w0)), f32(np.sin(w0))
    alpha = f32(sin_w0 / (2.0 * 0.707))
    if is_lpf:
        b0 = f32((1.0 - cos_w0) / 2.0)
        b1 = f32(1.0 - cos_w0)
        b2 = b0
    else:
        b0 = f32((1.0 + cos_w0) / 2.0)
        b1 = f32(-(1.0 + cos_w0))
        b2 = b0
    a0 = f32(1.0 + alpha)
    a1 = f32(-2.0 * cos_w0)
    a2 = f32(1.0 - alpha)
    return (f32(b0 / a0), f32(b1 / a0), f32(b2 / a0), f32(a1 / a0), f32(a2 / a0))


class BiquadState(NamedTuple):
    x1: jax.Array
    x2: jax.Array
    y1: jax.Array
    y2: jax.Array


def biquad_init() -> BiquadState:
    z = jnp.asarray(0.0, jnp.float32)
    return BiquadState(z, z, z, z)


_BIQUAD_BLOCK = 256


def biquad_apply(state: BiquadState, x: jax.Array, coeffs):
    """Direct-form-I biquad via *blocked* associative scan.

    y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2]
    The IIR recurrence is an affine map chained per sample; a naive parallel
    prefix over the full signal multiplies thousands of near-unit-circle
    companion matrices and blows up in f32 (the 40 Hz HPF's poles sit at
    r≈0.996 with transient growth ~100x).  Instead: parallel prefix *within*
    256-sample blocks (bounded products), sequential `lax.scan` across
    blocks — the carried state re-anchors each block.  The prefix form still
    amplifies f32 roundoff ~10x vs sequential direct-form-I (measured ~1e-3
    absolute on full-scale signals ≈ -50 dB — inaudible and well below the
    analysis floors); the bit-faithful sequential path is the C++ host
    reducer in runtime/.  Returns (new_state, y).
    """
    b0, b1, b2, a1, a2 = coeffs
    n = x.shape[0]
    x1 = jnp.concatenate([state.x1[None], x[:-1]])                      # x[n-1]
    x2 = jnp.concatenate([state.x2[None], state.x1[None], x[:-2]])[:n]  # x[n-2]
    f = b0 * x + b1 * x1 + b2 * x2

    blk = _BIQUAD_BLOCK
    n_pad = (-n) % blk
    f_pad = jnp.pad(f, (0, n_pad)).reshape(-1, blk)
    A = jnp.array([[-a1, -a2], [1.0, 0.0]], jnp.float32)
    As = jnp.broadcast_to(A, (blk, 2, 2))

    # HIGHEST: a default-precision f32 product may run in TF32 on the GPU.
    hi = jax.lax.Precision.HIGHEST

    def combine(left, right):
        A1, c1 = left
        A2, c2 = right
        return (jnp.matmul(A2, A1, precision=hi),
                jnp.einsum("...ij,...j->...i", A2, c1, precision=hi) + c2)

    def block_step(v0, f_blk):
        cs = jnp.stack([f_blk, jnp.zeros_like(f_blk)], axis=-1)
        As_acc, cs_acc = jax.lax.associative_scan(combine, (As, cs))
        v = jnp.einsum("nij,j->ni", As_acc, v0, precision=hi) + cs_acc
        return v[-1], v[:, 0]

    v0 = jnp.stack([state.y1, state.y2])
    _, y_blocks = jax.lax.scan(block_step, v0, f_pad)
    y = y_blocks.reshape(-1)[:n]
    new_state = BiquadState(x[-1], x1[-1], y[-1],
                            y[-2] if n > 1 else state.y1)
    return new_state, y


class GateState(NamedTuple):
    envelope: jax.Array
    hold_remaining: jax.Array  # int32


def gate_init() -> GateState:
    return GateState(jnp.asarray(0.0, jnp.float32), jnp.asarray(0, jnp.int32))


@partial(jax.jit, static_argnames=("sample_rate",))
def noise_gate(state: GateState, x: jax.Array, sample_rate: float):
    """Envelope-follower gate (ref mod.rs:392-471). Sequential scan per sample."""
    release_coeff = jnp.asarray(
        np.float32(np.exp(np.float32(-1.0) / np.float32(GATE_RELEASE_S * sample_rate))))
    threshold = jnp.asarray(np.float32(10.0 ** (GATE_THRESHOLD_DB / 20.0)))
    hold_samples = jnp.asarray(int(GATE_HOLD_S * sample_rate), jnp.int32)

    def step(s, xi):
        abs_in = jnp.abs(xi)
        attack = abs_in > s.envelope
        env = jnp.where(attack, abs_in,
                        release_coeff * s.envelope + (1.0 - release_coeff) * abs_in)
        hold = jnp.where(attack, hold_samples, s.hold_remaining)
        above = env >= threshold
        in_hold = (~above) & (hold > 0)
        ratio = env / threshold
        gain = jnp.where(above, 1.0,
                         jnp.where(in_hold, 1.0, ratio * ratio * ratio * ratio))
        hold = jnp.where(in_hold, hold - 1, hold)
        return GateState(env, hold), xi * gain

    return jax.lax.scan(step, state, x)


class ReducerState(NamedTuple):
    hp: BiquadState
    lp: BiquadState
    gate: GateState


def reducer_init() -> ReducerState:
    return ReducerState(biquad_init(), biquad_init(), gate_init())


@partial(jax.jit, static_argnames=("sample_rate", "mode"))
def reduce_signal(state: ReducerState, x: jax.Array, sample_rate: float,
                  mode: str = "exact"):
    """HPF 40 Hz → LPF 14 kHz → noise gate, over a 1-D chunk.

    * ``exact`` — one fused per-sample `lax.scan` (both biquads + gate in a
      single pass), numerically equivalent to the reference's f32 loop.
    * ``fast``  — blocked parallel-prefix biquads (~-35 dB fp deviation, see
      `biquad_apply`) + gate scan; higher device throughput on bulk audio.

    Returns (new_state, conditioned).  AGC (DynamicsTracker) is applied
    per-slot afterwards — see ops/dynamics.py.
    """
    hp_c = biquad_coeffs(HPF_FREQ, sample_rate, is_lpf=False)
    lp_c = biquad_coeffs(LPF_FREQ, sample_rate, is_lpf=True)
    if mode == "fast":
        hp, y = biquad_apply(state.hp, x.astype(jnp.float32), hp_c)
        lp, y = biquad_apply(state.lp, y, lp_c)
        gate, y = noise_gate(state.gate, y, sample_rate)
        return ReducerState(hp, lp, gate), y

    hb0, hb1, hb2, ha1, ha2 = hp_c
    lb0, lb1, lb2, la1, la2 = lp_c
    release_coeff = jnp.asarray(
        np.float32(np.exp(np.float32(-1.0) / np.float32(GATE_RELEASE_S * sample_rate))))
    threshold = jnp.asarray(np.float32(10.0 ** (GATE_THRESHOLD_DB / 20.0)))
    hold_samples = jnp.asarray(int(GATE_HOLD_S * sample_rate), jnp.int32)

    def step(s, xi):
        hp, lp, gt = s
        h = (hb0 * xi + hb1 * hp.x1 + hb2 * hp.x2
             - ha1 * hp.y1 - ha2 * hp.y2)
        hp = BiquadState(xi, hp.x1, h, hp.y1)
        l = (lb0 * h + lb1 * lp.x1 + lb2 * lp.x2
             - la1 * lp.y1 - la2 * lp.y2)
        lp = BiquadState(h, lp.x1, l, lp.y1)
        abs_in = jnp.abs(l)
        attack = abs_in > gt.envelope
        env = jnp.where(attack, abs_in,
                        release_coeff * gt.envelope + (1.0 - release_coeff) * abs_in)
        hold = jnp.where(attack, hold_samples, gt.hold_remaining)
        above = env >= threshold
        in_hold = (~above) & (hold > 0)
        ratio = env / threshold
        gain = jnp.where(above, 1.0,
                         jnp.where(in_hold, 1.0, ratio * ratio * ratio * ratio))
        hold = jnp.where(in_hold, hold - 1, hold)
        return (hp, lp, GateState(env, hold)), l * gain

    (hp, lp, gate), y = jax.lax.scan(step, (state.hp, state.lp, state.gate),
                                     x.astype(jnp.float32))
    return ReducerState(hp, lp, gate), y


# ── NumPy oracle: per-sample transcription (float32) ─────────────────────

class HostReducer:
    """Stateful streaming host-side reducer (float32 per-sample loop).

    This is the architectural twin of the reference's reducer thread — light
    sequential conditioning belongs on the host CPU (the reference runs it on
    a dedicated thread, ref mod.rs:336-511); the accelerator takes the
    batched FFT work.  Superseded by the C++ runtime reducer when built (runtime/)."""

    def __init__(self, sample_rate: float):
        f32 = np.float32
        self.sample_rate = sample_rate
        self.hp = biquad_coeffs(HPF_FREQ, sample_rate, is_lpf=False)
        self.lp = biquad_coeffs(LPF_FREQ, sample_rate, is_lpf=True)
        self.hp_state = [f32(0.0)] * 4   # x1 x2 y1 y2
        self.lp_state = [f32(0.0)] * 4
        self.threshold = f32(10.0 ** (GATE_THRESHOLD_DB / 20.0))
        self.envelope = f32(0.0)
        self.release = f32(np.exp(f32(-1.0) / f32(GATE_RELEASE_S * sample_rate)))
        self.hold_samples = int(GATE_HOLD_S * sample_rate)
        self.hold = 0

    def process(self, x: np.ndarray) -> np.ndarray:
        f32 = np.float32
        hb0, hb1, hb2, ha1, ha2 = self.hp
        lb0, lb1, lb2, la1, la2 = self.lp
        hx1, hx2, hy1, hy2 = self.hp_state
        lx1, lx2, ly1, ly2 = self.lp_state
        env, hold = self.envelope, self.hold
        out = np.empty(len(x), dtype=np.float32)
        for i, xi in enumerate(np.asarray(x, dtype=np.float32)):
            h = f32(hb0 * xi + hb1 * hx1 + hb2 * hx2 - ha1 * hy1 - ha2 * hy2)
            hx2, hx1, hy2, hy1 = hx1, xi, hy1, h
            l = f32(lb0 * h + lb1 * lx1 + lb2 * lx2 - la1 * ly1 - la2 * ly2)
            lx2, lx1, ly2, ly1 = lx1, h, ly1, l
            a = abs(l)
            if a > env:
                env = a
                hold = self.hold_samples
            else:
                env = f32(self.release * env + (f32(1.0) - self.release) * a)
            if env >= self.threshold:
                gain = f32(1.0)
            elif hold > 0:
                hold -= 1
                gain = f32(1.0)
            else:
                r = f32(env / self.threshold)
                gain = f32(r * r * r * r)
            out[i] = f32(l * gain)
        self.hp_state = [hx1, hx2, hy1, hy2]
        self.lp_state = [lx1, lx2, ly1, ly2]
        self.envelope, self.hold = env, hold
        return out


def reduce_signal_np(x: np.ndarray, sample_rate: float) -> np.ndarray:
    """Direct transcription of the reducer loop (ref mod.rs:408-472)."""
    f32 = np.float32
    hp = biquad_coeffs(HPF_FREQ, sample_rate, is_lpf=False)
    lp = biquad_coeffs(LPF_FREQ, sample_rate, is_lpf=True)
    hp_b0, hp_b1, hp_b2, hp_a1, hp_a2 = hp
    lp_b0, lp_b1, lp_b2, lp_a1, lp_a2 = lp
    hp_x1 = hp_x2 = hp_y1 = hp_y2 = f32(0.0)
    lp_x1 = lp_x2 = lp_y1 = lp_y2 = f32(0.0)
    thresh = f32(10.0 ** (GATE_THRESHOLD_DB / 20.0))
    envelope = f32(0.0)
    release = f32(np.exp(f32(-1.0) / f32(GATE_RELEASE_S * sample_rate)))
    hold_samples = int(GATE_HOLD_S * sample_rate)
    hold = 0
    out = np.empty(len(x), dtype=np.float32)
    for i, xi in enumerate(x.astype(np.float32)):
        h = f32(hp_b0 * xi + hp_b1 * hp_x1 + hp_b2 * hp_x2
                - hp_a1 * hp_y1 - hp_a2 * hp_y2)
        hp_x2, hp_x1, hp_y2, hp_y1 = hp_x1, xi, hp_y1, h
        l = f32(lp_b0 * h + lp_b1 * lp_x1 + lp_b2 * lp_x2
                - lp_a1 * lp_y1 - lp_a2 * lp_y2)
        lp_x2, lp_x1, lp_y2, lp_y1 = lp_x1, h, lp_y1, l
        abs_in = abs(l)
        if abs_in > envelope:
            envelope = abs_in
            hold = hold_samples
        else:
            envelope = f32(release * envelope + (f32(1.0) - release) * abs_in)
        if envelope >= thresh:
            gain = f32(1.0)
        elif hold > 0:
            hold -= 1
            gain = f32(1.0)
        else:
            ratio = f32(envelope / thresh)
            gain = f32(ratio * ratio * ratio * ratio)
        out[i] = f32(l * gain)
    return out
