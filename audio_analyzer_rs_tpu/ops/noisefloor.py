"""Variance-aware per-bin noise floor — `lax.scan` over STFT frames.

Port of the pitch worker's floor update (ref src/audio_io/stft.rs:209-367).
The reference carries [half_size] float arrays across frames on a worker
thread; here the same recurrence is a scan carry, so arbitrarily long audio
is one device program.  Constants are the reference's exactly
(ref stft.rs:219-225).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# lax.scan unroll factor (amortizes per-step loop overhead; carried over
# from an earlier build, not re-swept on the H100).
SCAN_UNROLL = 8

FLOOR_BASE_ALPHA = 0.04
FLOOR_FAST_ALPHA = 0.35
FLOOR_RELEASE = 0.02
VOL_MEMORY = 0.75
NOTE_RATIO = 1.5
NOTE_VOL_MAX = 0.15


class NoiseFloorState(NamedTuple):
    floor: jax.Array        # [H] per-bin noise floor
    prev_mag: jax.Array     # [H] previous frame magnitudes
    volatility: jax.Array   # [H] inter-frame jitter EMA
    initialized: jax.Array  # scalar bool


def init_state(half_size: int) -> NoiseFloorState:
    z = jnp.zeros((half_size,), dtype=jnp.float32)
    return NoiseFloorState(z, z, z, jnp.asarray(False))


def _step(state: NoiseFloorState, mags: jax.Array, global_floor: jax.Array):
    """One frame update → (new_state, effective_floor)."""
    # First-frame initialization (ref stft.rs:326-331).
    init_floor = jnp.maximum(mags, global_floor * 5.0)

    # Steady-state update (ref stft.rs:332-363).
    delta = jnp.abs(mags - state.prev_mag)
    vol = state.volatility * VOL_MEMORY + delta * (1.0 - VOL_MEMORY)
    floor = state.floor
    above_ratio = mags / jnp.maximum(floor, 0.01)
    vol_norm = jnp.clip(vol / jnp.maximum(mags, 0.05), 0.0, 1.0)
    is_sustained = (above_ratio > NOTE_RATIO) & (vol_norm < NOTE_VOL_MAX)
    alpha = jnp.where(mags > floor,
                      FLOOR_BASE_ALPHA + (FLOOR_FAST_ALPHA - FLOOR_BASE_ALPHA) * vol_norm,
                      FLOOR_RELEASE)
    updated = jnp.where(is_sustained, floor, floor + alpha * (mags - floor))

    new_floor = jnp.where(state.initialized, updated, init_floor)
    new_vol = jnp.where(state.initialized, vol, state.volatility)
    new_state = NoiseFloorState(new_floor, mags, new_vol,
                                jnp.asarray(True))
    effective = jnp.minimum(new_floor, global_floor * 2.5)  # ref stft.rs:365-367
    return new_state, effective


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("band",))
def noise_floor_scan(state: NoiseFloorState, mags: jax.Array,
                     global_floor: jax.Array, band: int | None = None):
    """mags [N, H], global_floor [N] → (final state, effective_floor [N, B]).

    global_floor is the linear global floor derived from the AGC's
    noise_floor_db: 10^(db/20) * half_size / 2 (ref stft.rs:322-324).

    `band` (static): run the recurrence on the first `band` bins only and
    pass the carried state above it through frozen — B = band.  Floors
    at/above the pitch candidate band (`ops.pitch.candidate_band`) are
    unobservable in pitch extraction (peaks and harmonic matches both
    require bins below the 10 kHz cap), so banding is output-exact there
    and ~2.2x cheaper.  Use band=None whenever the full-width floor itself
    is consumed (devtools visualization).

    `mags` may itself be banded (fewer columns than the state width, from a
    banded rDFT) as long as it covers `band`; the above-band state is then
    frozen with no first-frame seeding (those magnitudes were never
    computed).
    """
    half = state.floor.shape[-1]
    if band is None or band >= half:
        assert mags.shape[-1] >= half, (
            "full-width scan needs full-width magnitudes")
        def body(s, inp):
            m, g = inp
            return _step(s, m, g)
        return jax.lax.scan(body, state, (mags, global_floor),
                            unroll=SCAN_UNROLL)

    sub = NoiseFloorState(state.floor[:band], state.prev_mag[:band],
                          state.volatility[:band], state.initialized)

    def body(s, inp):
        m, g = inp
        return _step(s, m, g)
    sub, eff = jax.lax.scan(body, sub, (mags[:, :band], global_floor),
                            unroll=SCAN_UNROLL)
    # Above-band state: frozen while banded, but seed it once with the
    # first-frame rule on an uninitialized state (ref stft.rs:326-331).
    # Without this, switching the same state to a full-width scan later
    # (attaching the debug recorder mid-stream) would start the above-band
    # floors from zero instead of a plausible frame-seeded value.  With
    # banded input magnitudes there is nothing to seed from — the tail
    # stays frozen (only reachable from the lean segmented/bench path,
    # which never reads it).
    if mags.shape[-1] >= half:
        seed_floor = jnp.maximum(mags[0, band:half], global_floor[0] * 5.0)
        tail_floor = jnp.where(state.initialized, state.floor[band:],
                               seed_floor)
        tail_prev = jnp.where(state.initialized, state.prev_mag[band:],
                              mags[0, band:half])
    else:
        tail_floor = state.floor[band:]
        tail_prev = state.prev_mag[band:]
    new_state = NoiseFloorState(
        jnp.concatenate([sub.floor, tail_floor]),
        jnp.concatenate([sub.prev_mag, tail_prev]),
        jnp.concatenate([sub.volatility, state.volatility[band:]]),
        sub.initialized)
    return new_state, eff


def global_floor_linear(noise_floor_db, half_size: int):
    """ref stft.rs:322-324.

    Host values compute in numpy float32 on purpose: the live engine
    evaluates this once per flow per 21 ms slot, and an eager-jnp scalar
    chain (asarray → div → pow → mul → float()) costs several device
    round trips per call, which can dominate the streaming wall.  Traced
    inputs (the batched full step
    computes per-frame causal floors on device, parallel/sharding.py)
    keep the jnp form."""
    if isinstance(noise_floor_db, jax.Array):
        return (10.0 ** (jnp.asarray(noise_floor_db, jnp.float32) / 20.0)
                * (half_size / 2.0))
    return np.float32(
        np.float32(10.0) ** (np.float32(noise_floor_db) / np.float32(20.0))
        * np.float32(half_size / 2.0))


# ── NumPy oracle (direct transcription of the Rust loop) ─────────────────

def _fma32(a, b, c):
    """float32 fused multiply-add emulation: the exact product a*b is
    representable in float64 (f32 has 24 mantissa bits), so computing
    a*b + c in float64 and rounding once to float32 reproduces a hardware
    f32 FMA except in astronomically rare double-rounding ties."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def noise_floor_np(mags: np.ndarray, global_floor: np.ndarray,
                   fma: bool = False) -> np.ndarray:
    """[N, H] magnitudes → [N, H] effective floors, float32 loop transcription.

    `fma=False` is the plain transcription (every multiply and add rounds
    separately, like the reference's Rust f32 expressions without
    contraction).  `fma=True` contracts the alpha blend and the floor
    update into fused multiply-adds — the rounding XLA:CPU's LLVM backend
    actually emits for `_step`.  With fma=True the output is bitwise equal
    to `noise_floor_scan` at the production banded configuration on the
    CPU backend (verified over a 25 s mixed scene,
    tests/test_divergence_proof.py); the two variants differ only at
    1-ulp scale, which is precisely the fp32 sensitivity the composed
    divergence tests quantify."""
    n, h = mags.shape
    floor = np.zeros(h, dtype=np.float32)
    prev = np.zeros(h, dtype=np.float32)
    vol = np.zeros(h, dtype=np.float32)
    out = np.zeros_like(mags, dtype=np.float32)
    initialized = False
    for i in range(n):
        m = mags[i].astype(np.float32)
        g = np.float32(global_floor[i])
        if not initialized:
            floor = np.maximum(m, g * np.float32(5.0))
            prev = m.copy()
            initialized = True
        else:
            delta = np.abs(m - prev)
            vol = vol * np.float32(VOL_MEMORY) + delta * np.float32(1.0 - VOL_MEMORY)
            prev = m.copy()
            above = m / np.maximum(floor, np.float32(0.01))
            vn = np.clip(vol / np.maximum(m, np.float32(0.05)), 0.0, 1.0)
            sustained = (above > NOTE_RATIO) & (vn < NOTE_VOL_MAX)
            fast_minus_base = np.float32(FLOOR_FAST_ALPHA - FLOOR_BASE_ALPHA)
            if fma:
                alpha_hot = _fma32(fast_minus_base, vn,
                                   np.float32(FLOOR_BASE_ALPHA))
                updated = _fma32(np.where(m > floor, alpha_hot,
                                          np.float32(FLOOR_RELEASE)),
                                 m - floor, floor)
            else:
                alpha_hot = (np.float32(FLOOR_BASE_ALPHA)
                             + fast_minus_base * vn)
                alpha = np.where(m > floor, alpha_hot,
                                 np.float32(FLOOR_RELEASE))
                updated = floor + alpha * (m - floor)
            floor = np.where(sustained, floor, updated).astype(np.float32)
        out[i] = np.minimum(floor, g * np.float32(2.5))
    return out
