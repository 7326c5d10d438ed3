"""Pallas batched tracker scan vs the XLA scan (interpret mode on CPU).

The Triton-route kernel (ops/pallas_tracker.py) must make identical
DECISIONS to
vmap(tracker_scan): same greedy first-in-creation-order matching, same
rank-matched spawning, same reap/decay — across random polyphonic streams
with onsets, track churn, and slot exhaustion pressure.  Track frequency
VALUES are compared to a few ulps here: the EMA blend `f*0.6 + raw*0.4`
is one mul+mul+add whose FMA contraction each compiler chooses
independently, and a 1-ulp difference can carry through later blends
(scores are raw copies — exact; all integer/boolean state is exact).  On
the GPU the compiled kernel is checked at the segmented step's geometry
(`gpu` marker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_analyzer_rs_tpu.ops import tracker
from audio_analyzer_rs_tpu.ops.pallas_tracker import tracker_scan_pallas


def _assert_outputs_match(out_a, out_b):
    fa, sa, va = (np.asarray(x) for x in out_a)
    fb, sb, vb = (np.asarray(x) for x in out_b)
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_allclose(fa, fb, rtol=3e-7, atol=0)


def _assert_states_match(st_a, st_b):
    np.testing.assert_allclose(np.asarray(st_a.freq), np.asarray(st_b.freq),
                               rtol=3e-7, atol=0)
    for leaf in ("score", "life", "valid", "seq", "next_seq"):
        np.testing.assert_array_equal(np.asarray(getattr(st_a, leaf)),
                                      np.asarray(getattr(st_b, leaf)),
                                      err_msg=leaf)


def _random_raws(rng, s, n):
    rf = rng.uniform(50.0, 2000.0, (s, n, 8)).astype(np.float32)
    # Make consecutive frames often match (within 3% tolerance) so tracks
    # mature past the display threshold.
    for i in range(1, n):
        keep = rng.random((s, 8)) < 0.7
        rf[:, i] = np.where(keep, rf[:, i - 1] * (1 + rng.normal(
            0, 0.01, (s, 8)).astype(np.float32)), rf[:, i])
    rs = rng.uniform(0.1, 5.0, (s, n, 8)).astype(np.float32)
    rv = rng.random((s, n, 8)) < 0.6
    on = rng.random((s, n)) < 0.08
    return (jnp.asarray(rf), jnp.asarray(rs), jnp.asarray(rv),
            jnp.asarray(on))


def _init_states(s):
    return jax.vmap(lambda _: tracker.init_state())(jnp.arange(s))


@pytest.mark.parametrize("s,n", [(3, 40), (8, 17)])
def test_pallas_tracker_matches_xla(s, n):
    rng = np.random.default_rng(11)
    rf, rs, rv, on = _random_raws(rng, s, n)
    st = _init_states(s)

    st_x, out_x = tracker.tracker_scan_batched(st, rf, rs, rv, on,
                                               impl="xla")
    st_p, out_p = tracker.tracker_scan_batched(st, rf, rs, rv, on,
                                               impl="pallas_interpret")
    _assert_outputs_match(out_p, out_x)
    _assert_states_match(st_p, st_x)


def test_pallas_tracker_state_carry_across_calls():
    """Two chained calls (state threaded) must equal one call over the
    concatenated frames — the kernel's final-state writeback is the scan
    carry."""
    rng = np.random.default_rng(3)
    s, n = 4, 24
    rf, rs, rv, on = _random_raws(rng, s, 2 * n)
    st = _init_states(s)

    st_a, out_a = tracker.tracker_scan_batched(
        st, rf[:, :n], rs[:, :n], rv[:, :n], on[:, :n],
        impl="pallas_interpret")
    st_b, out_b = tracker.tracker_scan_batched(
        st_a, rf[:, n:], rs[:, n:], rv[:, n:], on[:, n:],
        impl="pallas_interpret")
    st_full, out_full = tracker.tracker_scan_batched(
        st, rf, rs, rv, on, impl="pallas_interpret")
    joined = tuple(
        np.concatenate([np.asarray(a), np.asarray(b)], axis=1)
        for a, b in zip(out_a, out_b))
    _assert_outputs_match(joined, tuple(np.asarray(x) for x in out_full))
    _assert_states_match(st_b, st_full)


@pytest.mark.parametrize("s,block", [(6, 4), (5, 2), (3, 8)])
def test_pallas_tracker_ragged_stream_blocks(s, block):
    """Stream counts that are not a multiple of the block: the pad streams
    run on inert state and are sliced off."""
    rng = np.random.default_rng(s)
    rf, rs, rv, on = _random_raws(rng, s, 21)
    st = _init_states(s)
    st_x, out_x = tracker.tracker_scan_batched(st, rf, rs, rv, on,
                                               impl="xla")
    st_p, out_p = tracker_scan_pallas(st, rf, rs, rv, on, interpret=True,
                                      block_streams=block)
    assert out_p[0].shape == (s, 21, 8)
    _assert_outputs_match(out_p, out_x)
    _assert_states_match(st_p, st_x)


@pytest.mark.parametrize("platform,want", [("gpu", "pallas"),
                                           ("cpu", "xla")])
def test_tracker_impl_follows_platform(monkeypatch, platform, want):
    """impl=None takes the kernel on the GPU and the XLA scan elsewhere."""
    class _Dev:
        pass
    dev = _Dev()
    dev.platform = platform
    monkeypatch.setattr(tracker.jax, "devices", lambda *a: [dev])
    seen = []
    import audio_analyzer_rs_tpu.ops.pallas_tracker as pt
    monkeypatch.setattr(pt, "tracker_scan_pallas",
                        lambda *a, **k: seen.append("pallas") or "k")
    monkeypatch.setattr(tracker, "tracker_scan",
                        lambda *a: seen.append("xla") or a)
    rng = np.random.default_rng(0)
    rf, rs, rv, on = _random_raws(rng, 2, 3)
    tracker.tracker_scan_batched.__wrapped__(_init_states(2), rf, rs, rv, on)
    assert seen and set(seen) == {want}


def test_tracker_impl_unknown_raises():
    rng = np.random.default_rng(0)
    rf, rs, rv, on = _random_raws(rng, 2, 3)
    with pytest.raises(ValueError, match="impl"):
        tracker.tracker_scan_batched(_init_states(2), rf, rs, rv, on,
                                     impl="mosaic")


@pytest.mark.gpu
def test_compiled_tracker_kernel_matches_xla_on_card():
    """The kernel as compiled for the card, at the segmented step's
    geometry (128 segments x 64 frames): integers and booleans exact,
    frequencies within 1 ulp."""
    rng = np.random.default_rng(21)
    rf, rs, rv, on = _random_raws(rng, 128, 64)
    st = _init_states(128)
    st_x, out_x = tracker.tracker_scan_batched(st, rf, rs, rv, on,
                                               impl="xla")
    st_p, out_p = tracker.tracker_scan_batched(st, rf, rs, rv, on)
    np.testing.assert_array_equal(np.asarray(out_p[2]), np.asarray(out_x[2]))
    np.testing.assert_array_equal(np.asarray(out_p[1]), np.asarray(out_x[1]))
    np.testing.assert_allclose(np.asarray(out_p[0]), np.asarray(out_x[0]),
                               rtol=1.2e-7, atol=0)
    _assert_states_match(st_p, st_x)
