"""Precision audit: every float32 matrix product on the main path asks for
`Precision.HIGHEST`.

On the GPU a float32 `dot_general` at default precision may run in TF32,
which keeps about 10 mantissa bits: it would round tracked frequencies and
the biquad combine, which the parity tests pin bit-exact.  The CPU never
shows that rounding, so this test reads the programs instead: it walks each
jitted entry point's jaxpr, sub-jaxprs included, and fails on any f32
`dot_general` whose precision is not HIGHEST on both operands."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

from audio_analyzer_rs_tpu.models.analyzer import fused_slot_step
from audio_analyzer_rs_tpu.models.segmented import _vmapped_step
from audio_analyzer_rs_tpu.ops import noisefloor, onset, reducer, tracker
from audio_analyzer_rs_tpu.ops.stft import (ONSET_HOP, ONSET_WINDOW,
                                            PITCH_HOP, PITCH_WINDOW)
from audio_analyzer_rs_tpu.utils.framing import num_frames

HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(params):
    for v in params.values():
        for item in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(item, ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, Jaxpr):
                yield item


def _is_highest(precision) -> bool:
    if precision is None:
        return False
    if isinstance(precision, jax.lax.Precision):
        return precision == HIGHEST
    if isinstance(precision, (tuple, list)):
        return all(p == HIGHEST for p in precision)
    return False   # a DotAlgorithmPreset: not the plain HIGHEST request


def loose_f32_dots(jaxpr) -> list:
    """f32 dot_generals below HIGHEST, as 'shapes: precision' strings."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dtypes = {v.aval.dtype for v in eqn.invars}
            if jnp.dtype(jnp.float32) in dtypes and not _is_highest(
                    eqn.params.get("precision")):
                found.append(f"{[v.aval.shape for v in eqn.invars]}: "
                             f"{eqn.params.get('precision')}")
        for sub in _sub_jaxprs(eqn.params):
            found += loose_f32_dots(sub)
    return found


def _tracker_inputs(s=None, n=12):
    rng = np.random.default_rng(0)
    lead = () if s is None else (s,)
    rf = jnp.asarray(rng.uniform(80, 900, lead + (n, 8)), jnp.float32)
    rs = jnp.asarray(rng.uniform(0, 4, lead + (n, 8)), jnp.float32)
    rv = jnp.asarray(rng.random(lead + (n, 8)) < 0.5)
    on = jnp.asarray(rng.random(lead + (n,)) < 0.1)
    st = tracker.init_state()
    if s is not None:
        st = jax.tree.map(lambda a: jnp.broadcast_to(a, (s,) + a.shape), st)
    return st, rf, rs, rv, on


def _case_tracker_scan():
    return tracker.tracker_scan, _tracker_inputs()


def _case_select_stable():
    rng = np.random.default_rng(1)
    t = tracker.MAX_TRACKS
    return tracker.select_stable, (
        jnp.asarray(rng.uniform(80, 900, (5, t)), jnp.float32),
        jnp.asarray(rng.uniform(0, 4, (5, t)), jnp.float32),
        jnp.asarray(rng.random((5, t)) < 0.5),
        jnp.asarray(rng.permutation(5 * t).reshape(5, t), jnp.int32))


def _case_tracker_scan_batched():
    return (partial(tracker.tracker_scan_batched, impl="xla"),
            _tracker_inputs(s=3))


def _case_reduce_signal():
    x = jnp.asarray(np.random.default_rng(2).standard_normal(4096) * 0.1,
                    jnp.float32)
    return (partial(reducer.reduce_signal, sample_rate=48000.0, mode="fast"),
            (reducer.reducer_init(), x))


def _case_fused_slot_step():
    rng = np.random.default_rng(3)
    slot_len, p_len, o_len = 1024, PITCH_WINDOW - PITCH_HOP, 192
    n_o = num_frames(o_len + slot_len, ONSET_WINDOW, ONSET_HOP)
    host_vec = np.concatenate([
        (rng.standard_normal(slot_len) * 0.1).astype(np.float32),
        np.asarray([1e-3, 1e-3, 0.0], np.float32), np.zeros(n_o, np.float32)])
    fn = partial(fused_slot_step, sample_rate=48000.0, slot_len=slot_len,
                 p_tail_len=p_len, o_tail_len=o_len)
    return fn, (noisefloor.init_state(PITCH_WINDOW // 2 + 1),
                tracker.init_state(),
                onset.init_state(ONSET_WINDOW // 2 + 1), jnp.asarray(False),
                jnp.zeros(p_len, jnp.float32), jnp.zeros(o_len, jnp.float32),
                jnp.asarray(host_vec))


def _case_vmapped_step():
    segs, cf = 2, 8
    samples = (cf - 1) * PITCH_HOP + PITCH_WINDOW

    def rep(st):
        return jax.tree.map(lambda a: jnp.broadcast_to(a, (segs,) + a.shape),
                            st)
    audio = jnp.asarray(np.random.default_rng(4).standard_normal(
        (segs, samples)) * 0.1, jnp.float32)
    fn = partial(_vmapped_step, sample_rate=44100.0, window=PITCH_WINDOW,
                 hop=PITCH_HOP)
    return fn, (rep(noisefloor.init_state(PITCH_WINDOW // 2 + 1)),
                rep(tracker.init_state()), audio,
                jnp.full((segs, cf), 1e-3, jnp.float32),
                jnp.zeros((segs, cf), bool))


CASES = {
    "tracker_scan": _case_tracker_scan,
    "select_stable": _case_select_stable,
    "tracker_scan_batched": _case_tracker_scan_batched,
    "reduce_signal": _case_reduce_signal,
    "fused_slot_step": _case_fused_slot_step,
    "vmapped_step": _case_vmapped_step,
}


@pytest.mark.parametrize("name", list(CASES))
def test_f32_matmuls_ask_for_highest(name):
    fn, args = CASES[name]()
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    loose = loose_f32_dots(jaxpr)
    assert not loose, f"{name}: f32 dot_general below HIGHEST: {loose}"


def test_audit_catches_a_default_precision_dot():
    """The walker itself: a default-precision f32 product nested in a scan
    is found, and the same product at HIGHEST is not."""
    def body(c, x, precision=None):
        return c, jnp.dot(x, x, precision=precision)

    xs = jnp.ones((3, 4, 4), jnp.float32)
    loose = jax.make_jaxpr(lambda xs: jax.lax.scan(body, 0.0, xs))(xs)
    tight = jax.make_jaxpr(lambda xs: jax.lax.scan(
        partial(body, precision=HIGHEST), 0.0, xs))(xs)
    assert len(loose_f32_dots(loose.jaxpr)) == 1
    assert loose_f32_dots(tight.jaxpr) == []
