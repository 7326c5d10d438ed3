"""EnginePool parity: K pooled live engines vs K independently-driven ones.

The pool (api/pool.py) steps K engines in lockstep and batches each slot
wave into ONE vmapped device program (models/analyzer.fused_slot_pool_step).
Per-engine results must match driving each engine alone: same onset event
streams, same tuner readings, analyzer states equal under the aggregate-mode
numeric contract (consumer surfaces bit-equal; noise-floor IIR leaves may
carry ulp-level FMA-contraction drift — the batched module is a different
XLA program, the precision-only divergence class of
tests/test_divergence_proof.py).  Ref: the reference can only run ONE
engine per process (src/audio_io/mod.rs:960-1129) — this is the
rebuild's qualitative win, so the parity here is what makes it honest.
"""

import json

import numpy as np

from audio_analyzer_rs_tpu.api.device import ArraySource
from audio_analyzer_rs_tpu.api.engine import AudioEngine
from audio_analyzer_rs_tpu.api.pool import EnginePool
from audio_analyzer_rs_tpu.models import generators as gen

SR = 48000.0
# Seeds whose mixed scenes complete loopback calibration and fire onsets
# within the 3 s session (most seeds' scenes fire nothing that early, which
# would make the event-stream parity trivially vacuous for that engine).
SEEDS = (11, 23, 42)


def _make_engine(seed: int, seconds: float):
    scene = gen.mixed_scene(seconds + 0.5, SR, seed=seed)
    e = AudioEngine(input_source=ArraySource(scene), sample_rate=SR,
                    loopback_latency_samples=2048, loopback_gain=1.0)
    tuner = e.start_tuner()
    onset = e.start_onset_detection()
    return e, tuner, onset


def _run_pooled(seeds, seconds=3.0, depth=1, aggregate=2, pause_at=-1):
    """Lockstep-pooled session; returns per-engine (engine, events, tuner)."""
    members = [_make_engine(s, seconds) for s in seeds]
    pool = EnginePool([e for e, _, _ in members], pipeline_depth=depth,
                      aggregate_slots=aggregate)
    slot_s = members[0][0].buffer_size / SR
    n_slots = int(seconds / slot_s)
    events = [[] for _ in members]
    for i in range(n_slots):
        if pause_at >= 0 and i == pause_at:
            members[0][2].pause()
        if pause_at >= 0 and i == pause_at + 12:
            members[0][2].resume()
        pool.step_wave()
        for k, (_, _, onset) in enumerate(members):
            events[k].extend(json.loads(onset.poll_onsets()))
    pool.flush()
    for k, (_, _, onset) in enumerate(members):
        events[k].extend(json.loads(onset.poll_onsets()))
    return pool, members, events


def _run_solo(seed, seconds=3.0, pause_at=-1):
    """The reference scenario: one engine, driven alone (fused, depth 0)."""
    e, tuner, onset = _make_engine(seed, seconds)
    slot_s = e.buffer_size / SR
    events = []
    for i in range(int(seconds / slot_s)):
        if pause_at >= 0 and i == pause_at:
            onset.pause()
        if pause_at >= 0 and i == pause_at + 12:
            onset.resume()
        e.advance(slot_s)
        events.extend(json.loads(onset.poll_onsets()))
    return e, events, tuner


def _consumers(e):
    from audio_analyzer_rs_tpu.api.engine import (_OnsetConsumer,
                                                  _PitchConsumer)
    pc = next(c for c in e._consumers.values()
              if isinstance(c, _PitchConsumer))
    oc = next(c for c in e._consumers.values()
              if isinstance(c, _OnsetConsumer))
    return pc, oc


def _assert_states_match(ea, eb):
    """Aggregate-mode state contract (see tests/test_fused_streaming.py
    _assert_states_equal_agg): everything bit-equal except the noise-floor
    IIR leaves (floor, volatility), allowed bounded ulp-relative drift."""
    pa, oa = _consumers(ea)
    pb, ob = _consumers(eb)
    assert pa.analyzer.frames_consumed == pb.analyzer.frames_consumed
    assert oa.analyzer.frames_consumed == ob.analyzer.frames_consumed
    np.testing.assert_array_equal(np.asarray(pa.analyzer._tail),
                                  np.asarray(pb.analyzer._tail))
    np.testing.assert_array_equal(np.asarray(oa.analyzer._tail),
                                  np.asarray(ob.analyzer._tail))
    for name, a, b in zip(pa.analyzer.nf_state._fields,
                          pa.analyzer.nf_state, pb.analyzer.nf_state):
        a, b = np.asarray(a), np.asarray(b)
        if name in ("floor", "volatility"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(pa.analyzer.tr_state, pb.analyzer.tr_state):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(oa.analyzer.state, ob.analyzer.state):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pool_matches_independent_engines():
    """K=3 pooled engines (deferred, aggregated waves) must reproduce each
    engine's solo run: event streams, final tuner reading, states,
    calibration offsets."""
    pool, members, ev_pool = _run_pooled(SEEDS)
    for k, seed in enumerate(SEEDS):
        e_solo, ev_solo, tuner_solo = _run_solo(seed)
        e_pool, tuner_pool, _ = members[k]
        assert ev_pool[k] == ev_solo and len(ev_solo) > 0, f"engine {k}"
        assert tuner_pool.poll_output() == tuner_solo.poll_output()
        _assert_states_match(e_solo, e_pool)
        assert (e_pool.transport.get_calibration_offset()
                == e_solo.transport.get_calibration_offset())
    # Every slot of every engine must have gone through the fused path,
    # and the pool must actually have dispatched waves.
    slot_s = members[0][0].buffer_size / SR
    n_slots = int(3.0 / slot_s)
    for e, _, _ in members:
        assert e._fused_slots == n_slots
    assert pool.waves > 0


def test_pool_member_pause_falls_back():
    """A paused member drops out of the wave (sequential fallback) and back
    in on resume — outputs still match its solo run with the same script,
    and the other member keeps matching too."""
    pool, members, ev_pool = _run_pooled(SEEDS[:2], pause_at=100)
    for k, seed in enumerate(SEEDS[:2]):
        pa = 100 if k == 0 else -1
        e_solo, ev_solo, _ = _run_solo(seed, pause_at=pa)
        assert ev_pool[k] == ev_solo, f"engine {k}"
        _assert_states_match(e_solo, members[k][0])


def test_pool_remove_returns_engine_to_solo():
    """remove() mid-run surfaces deferred results and the engine continues
    standalone, still matching an end-to-end solo run."""
    members = [_make_engine(s, 3.0) for s in SEEDS[:2]]
    pool = EnginePool([e for e, _, _ in members], pipeline_depth=1,
                      aggregate_slots=2)
    slot_s = members[0][0].buffer_size / SR
    n_slots = int(3.0 / slot_s)
    events = [[] for _ in members]
    for i in range(n_slots):
        if i == n_slots // 2:
            pool.remove(members[0][0])
            assert members[0][0]._pool is None
        if members[0][0]._pool is None:
            members[0][0].advance(slot_s)
            pool.step_wave()
        else:
            pool.step_wave()
        for k, (_, _, onset) in enumerate(members):
            events[k].extend(json.loads(onset.poll_onsets()))
    pool.flush()
    members[0][0].flush_analysis()
    for k, (_, _, onset) in enumerate(members):
        events[k].extend(json.loads(onset.poll_onsets()))
    for k, seed in enumerate(SEEDS[:2]):
        e_solo, ev_solo, _ = _run_solo(seed)
        assert events[k] == ev_solo, f"engine {k}"
        _assert_states_match(e_solo, members[k][0])


def test_pool_checkpoint_mid_stream(tmp_path):
    """checkpoint.save_engine on a pooled member flushes the pool's deferred
    waves first: the snapshot equals the solo engine's (noise-floor IIR
    leaves under the aggregate-mode ulp contract)."""
    from audio_analyzer_rs_tpu import checkpoint

    members = [_make_engine(s, 2.0) for s in SEEDS[:2]]
    pool = EnginePool([e for e, _, _ in members], pipeline_depth=1,
                      aggregate_slots=4)
    pool.advance(2.0)
    # Solo twin advanced WITHOUT per-slot polling: poll_onsets drains the
    # event queue, and neither pooled member was polled above, so the
    # snapshots must be taken from identically-(un)polled engines.
    e_solo, _, _ = _make_engine(SEEDS[0], 2.0)
    e_solo.advance(2.0)
    p_a = str(tmp_path / "pooled.npz")
    p_b = str(tmp_path / "solo.npz")
    checkpoint.save_engine(p_a, members[0][0])
    checkpoint.save_engine(p_b, e_solo)
    a = np.load(p_a, allow_pickle=True)
    b = np.load(p_b, allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if k == "meta_json":
            assert str(a[k]) == str(b[k])
        elif k in ("tuner_nf_0", "tuner_nf_2"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=2e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pool_mid_join_keeps_members_pipelined():
    """One student joining mid-class must not stall the classroom: the
    joiner calibrates in its own per-wave hold group (drained with a
    one-wave lag), while the steady members KEEP their aggregation and
    pipelining (r4 forced the whole pool synchronous/per-wave while any
    member calibrated).  Everyone still matches their
    solo runs exactly.  Ref onset.rs:404-440: calibration acceptance
    rewrites only the calibrating engine's scan state."""
    seconds = 4.0
    members = [_make_engine(s, seconds) for s in SEEDS[:2]]
    pool = EnginePool([e for e, _, _ in members], pipeline_depth=1,
                      aggregate_slots=2, capacity=3)
    slot_s = members[0][0].buffer_size / SR
    n_slots = int(seconds / slot_s)
    join_at = 70     # both founders calibrated + aggregating by then
    joiner_seconds = (n_slots - join_at + 0.5) * slot_s
    events = [[], [], []]
    agg_during_join = 0
    hold_lag_waves = 0
    for i in range(n_slots):
        if i == join_at:
            members.append(_make_engine(SEEDS[2], joiner_seconds))
            pool.add(members[2][0])
        before_agg = pool._agg_dispatches
        pool.step_wave()
        if (len(members) == 3
                and not _consumers(members[2][0])[1].calibration_done):
            # The join window: the founders' aggregate dispatches keep
            # landing, and the joiner's dispatch sits on the hold queue
            # (surfacing next wave) instead of blocking this one.
            agg_during_join += pool._agg_dispatches - before_agg
            hold_lag_waves += 1 if pool._hold_queue else 0
        for k, (_, _, onset) in enumerate(members):
            events[k].extend(json.loads(onset.poll_onsets()))
    pool.flush()
    for k, (_, _, onset) in enumerate(members):
        events[k].extend(json.loads(onset.poll_onsets()))
    assert _consumers(members[2][0])[1].calibration_done
    # The joiner's acceptance landed while its next slot was already
    # speculatively in flight.
    assert pool._rollbacks >= 1
    assert agg_during_join > 0, \
        "founders' aggregation was suspended during the join"
    assert hold_lag_waves > 0, \
        "joiner's calibration dispatches never used the hold queue"
    for k, seed in enumerate(SEEDS[:2]):
        e_solo, ev_solo, _ = _run_solo(seed, seconds=seconds)
        assert events[k] == ev_solo and len(ev_solo) > 0, f"founder {k}"
        _assert_states_match(e_solo, members[k][0])
    e_solo, ev_solo, _ = _run_solo(SEEDS[2], seconds=joiner_seconds)
    assert events[2] == ev_solo and len(ev_solo) > 0, "joiner"
    _assert_states_match(e_solo, members[2][0])


def test_pool_prepare_covers_wave_programs():
    """EnginePool.prepare()'s coverage claim, enforced (the pool twin of
    test_fused_streaming.test_prepare_covers_all_slot_programs): after
    prepare(), a full pooled live session — every member's loopback
    calibration, the staggered hold->steady transitions, aggregated
    steady waves, and the final flush — adds ZERO new jit cache entries
    to the wave program."""
    import jax

    from audio_analyzer_rs_tpu.models import analyzer as an

    jax.clear_caches()
    cfg_pool = EnginePool(
        [AudioEngine(sample_rate=SR, buffer_size=1024) for _ in range(2)],
        pipeline_depth=1, aggregate_slots=2)
    cfg_pool.prepare()
    before = an.fused_slot_pool_step._cache_size()
    pool, members, _ = _run_pooled(SEEDS[:2])
    after = an.fused_slot_pool_step._cache_size()
    assert after == before, (
        f"pooled session compiled wave programs prepare() missed "
        f"({before}->{after})")
    for e, _, _ in members:
        assert _consumers(e)[1].calibration_done
    assert pool._agg_dispatches > 0


def test_pool_speculative_calibration_rolls_back_and_matches():
    """Calibration slots dispatch speculatively (next slot in flight
    before the previous result lands); the at-most-once transition —
    click acceptance here — must trigger a rollback + rebuild of the one
    in-flight dispatch, and the result must still be bit-identical to
    the solo synchronous ordering.  Guards _calibration_transition
    against drifting from _post."""
    pool, members, ev_pool = _run_pooled(SEEDS)
    # Every member's loopback acceptance lands while its next slot is in
    # flight -> one rollback per member.
    assert pool._rollbacks == len(SEEDS), pool._rollbacks
    for k, seed in enumerate(SEEDS):
        e_solo, ev_solo, _ = _run_solo(seed)
        assert ev_pool[k] == ev_solo and len(ev_solo) > 0, f"engine {k}"
        _assert_states_match(e_solo, members[k][0])


def test_pool_timeout_transition_rolls_back_and_matches():
    """The calibration TIMEOUT (no loopback: offset-0 fallback at 2 s,
    ref onset.rs:361-371) is the other speculation-invalidating
    transition: the hold flag flips, so the in-flight optimistic slot
    was built wrong and must be rebuilt.  Pooled must match solo through
    the timeout boundary."""
    seconds = 2.5
    scenes = {s: gen.mixed_scene(seconds + 0.5, SR, seed=s) for s in (5, 6)}

    def make(seed):
        e = AudioEngine(input_source=ArraySource(scenes[seed]),
                        sample_rate=SR)   # NO loopback -> timeout path
        tuner = e.start_tuner()
        onset = e.start_onset_detection()
        return e, tuner, onset

    members = [make(s) for s in (5, 6)]
    pool = EnginePool([e for e, _, _ in members], pipeline_depth=1,
                      aggregate_slots=2)
    slot_s = members[0][0].buffer_size / SR
    n_slots = int(seconds / slot_s)
    events = [[], []]
    for _ in range(n_slots):
        pool.step_wave()
        for k, (_, _, onset) in enumerate(members):
            events[k].extend(json.loads(onset.poll_onsets()))
    pool.flush()
    for k, (_, _, onset) in enumerate(members):
        events[k].extend(json.loads(onset.poll_onsets()))
    assert pool._rollbacks == 2, pool._rollbacks
    for k, seed in enumerate((5, 6)):
        e_solo, tuner_solo, onset_solo = make(seed)
        ev_solo = []
        for _ in range(n_slots):
            e_solo.advance(slot_s)
            ev_solo.extend(json.loads(onset_solo.poll_onsets()))
        assert _consumers(e_solo)[1].calibration_done
        assert _consumers(members[k][0])[1].calibration_done
        assert events[k] == ev_solo, f"engine {k}"
        _assert_states_match(e_solo, members[k][0])


def test_pool_prepare_covers_mid_join_at_capacity():
    """The zero-compile mid-join claim: a pool PREPARED at capacity C
    must run a live session where a fresh member joins mid-run — hold
    dispatches, speculative redispatch, steady padding, the post-join
    full wave — without a single new wave-program compile."""
    import jax

    from audio_analyzer_rs_tpu.models import analyzer as an

    jax.clear_caches()
    cfg_pool = EnginePool(
        [AudioEngine(sample_rate=SR, buffer_size=1024) for _ in range(2)],
        pipeline_depth=1, aggregate_slots=2, capacity=3)
    cfg_pool.prepare()
    before = an.fused_slot_pool_step._cache_size()

    seconds = 4.0
    members = [_make_engine(s, seconds) for s in SEEDS[:2]]
    pool = EnginePool([e for e, _, _ in members], pipeline_depth=1,
                      aggregate_slots=2, capacity=3)
    slot_s = members[0][0].buffer_size / SR
    n_slots = int(seconds / slot_s)
    join_at = 70
    joiner_seconds = (n_slots - join_at + 0.5) * slot_s
    for i in range(n_slots):
        if i == join_at:
            members.append(_make_engine(SEEDS[2], joiner_seconds))
            pool.add(members[2][0])
        pool.step_wave()
    pool.flush()
    after = an.fused_slot_pool_step._cache_size()
    assert after == before, (
        f"mid-join session compiled wave programs prepare() missed "
        f"({before}->{after})")
    assert _consumers(members[2][0])[1].calibration_done
    assert pool._rollbacks >= 1


def test_pool_scheduling_fuzz():
    """Randomized scheduling churn — per-engine pauses/resumes, pool
    flushes at arbitrary waves, and a mid-run join — must never break
    per-engine parity with solo runs under the same schedule.  This is
    the integration fuzz over ALL the pool machinery at once: speculative
    calibration + rollback, capacity padding, partial-aggregate
    decomposition, hold/steady partitioning, membership change."""
    import random

    for trial, master_seed in enumerate((7, 19)):
        rng = random.Random(master_seed)
        seconds = 3.0
        members = [_make_engine(s, seconds) for s in SEEDS[:2]]
        pool = EnginePool([e for e, _, _ in members], pipeline_depth=1,
                          aggregate_slots=rng.choice((2, 3, 4)),
                          capacity=3)
        slot_s = members[0][0].buffer_size / SR
        n_slots = int(seconds / slot_s)
        join_at = rng.randrange(40, 90)
        joiner_seconds = (n_slots - join_at + 0.5) * slot_s
        # Random pause windows per founder (post-calibration region so the
        # pause interacts with steady aggregation, not the hold path).
        pauses = {}
        for k in range(2):
            if rng.random() < 0.8:
                start = rng.randrange(75, 110)
                pauses[k] = (start, start + rng.randrange(5, 20))
        flush_waves = sorted(rng.sample(range(10, n_slots), 4))
        events = [[], [], []]
        for i in range(n_slots):
            if i == join_at:
                members.append(_make_engine(SEEDS[2], joiner_seconds))
                pool.add(members[2][0])
            for k, (s0, s1) in pauses.items():
                if i == s0:
                    members[k][2].pause()
                if i == s1:
                    members[k][2].resume()
            pool.step_wave()
            if i in flush_waves:
                pool.flush()
            for k, (_, _, onset) in enumerate(members):
                events[k].extend(json.loads(onset.poll_onsets()))
        pool.flush()
        for k, (_, _, onset) in enumerate(members):
            events[k].extend(json.loads(onset.poll_onsets()))

        def run_solo_scripted(seed, seconds, pause, offset):
            e, _, onset = _make_engine(seed, seconds)
            ev = []
            for i in range(int(seconds / slot_s)):
                if pause and i + offset == pause[0]:
                    onset.pause()
                if pause and i + offset == pause[1]:
                    onset.resume()
                e.advance(slot_s)
                ev.extend(json.loads(onset.poll_onsets()))
            e.flush_analysis()
            ev.extend(json.loads(onset.poll_onsets()))
            return e, ev

        for k, seed in enumerate(SEEDS[:2]):
            e_solo, ev_solo = run_solo_scripted(seed, seconds,
                                                pauses.get(k), 0)
            assert events[k] == ev_solo, f"trial {trial} founder {k}"
            _assert_states_match(e_solo, members[k][0])
        e_solo, ev_solo = run_solo_scripted(SEEDS[2], joiner_seconds,
                                            None, join_at)
        assert events[2] == ev_solo, f"trial {trial} joiner"
        _assert_states_match(e_solo, members[2][0])


def test_pooled_classroom_practice_sessions_match_solo(tmp_path):
    """The actual classroom product scenario: K students each run a full
    PRACTICE SESSION (MIDI reference, live scoring, end-of-session
    metrics) while their engines are pooled — every slot wave one batched
    dispatch with deferred readback.  Each pooled student's feedback and
    metrics must equal a solo run of the same engine config (same
    pipeline_depth/aggregate_slots), note for note."""
    import pytest

    from audio_analyzer_rs_tpu.utils.midi import write_midi_file

    midi_path = str(tmp_path / "ref.mid")
    notes = [(60, 0.0, 0.9, 90), (64, 1.0, 0.9, 90), (67, 2.0, 0.9, 90),
             (72, 3.0, 0.9, 90),
             (72, 4.0, 0.9, 90), (67, 5.0, 0.9, 90), (64, 6.0, 0.9, 90),
             (60, 7.0, 0.9, 90)]
    write_midi_file(midi_path, notes, bpm=120.0)
    perf = np.zeros(int(SR * 6.0), dtype=np.float32)
    for midi, start, dur, _vel in notes:
        freq = 440.0 * 2.0 ** ((midi - 69) / 12.0)
        tone = gen.tone_with_harmonics(freq, dur * 0.5 * 0.9, SR,
                                       harmonics=6, amplitude=0.35)
        s = int(start * 0.5 * SR)
        perf[s:s + len(tone)] += tone

    def make_student():
        e = AudioEngine(input_source=ArraySource(perf))
        e.pipeline_depth = 1
        e.aggregate_slots = 2
        e.transport.set_calibration_offset(1)   # offline: no latency
        e.transport.set_input_latency(0)
        e.transport.set_output_latency(0)
        session = e.create_practice_session(midi_path, "Piano", 0,
                                            "Performance", "Beginner",
                                            120.0)
        session.start(0, 1)
        return e, session

    K = 3
    students = [make_student() for _ in range(K)]
    pool = EnginePool([e for e, _ in students], pipeline_depth=1,
                      aggregate_slots=2, capacity=K)
    slot_s = students[0][0].buffer_size / SR
    n_slots = int(5.5 / slot_s)
    for _ in range(n_slots):
        pool.step_wave()
    pool.flush()

    e_solo, s_solo = make_student()
    for _ in range(n_slots):
        e_solo.advance(slot_s)
    e_solo.flush_analysis()

    assert not s_solo.is_running()
    solo_metrics = json.loads(s_solo.get_metrics())
    assert solo_metrics["accuracy_percent"] >= 75.0, solo_metrics
    solo_transport = json.loads(s_solo.poll_transport())
    for k, (e, session) in enumerate(students):
        assert not session.is_running(), f"student {k} still running"
        assert json.loads(session.get_metrics()) == solo_metrics, \
            f"student {k}"
        assert json.loads(session.poll_transport()) == solo_transport, \
            f"student {k}"


def test_pool_depth0_transition_preserves_event_order():
    """At pipeline_depth=0 / aggregate_slots=1 (the synchronous default),
    the slot rebuilt at the calibration transition must post BEFORE the
    engine's first steady slot — the rebuilt dispatch is drained
    immediately at the transition, not deferred to the next wave's end
    (which would invert event order vs solo).  Scene: dense clicks
    around the 2 s calibration timeout so both the rebuilt slot and the
    following steady slots carry fired onsets."""
    def scene(seed):
        # Clicks at slots 94-96: the 2 s timeout transition is detected
        # draining slot 93 (end of wave 94), so the rebuilt slot is 94 —
        # it and the first steady slots all carry fired onsets, making
        # any post-ordering inversion visible in the event stream.
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal(int(SR * 3.0)) * 1e-5).astype(np.float32)
        click = gen.calibration_click(SR, volume=0.8)
        for slot in (94, 95, 96):
            s = int((slot + 0.3) * 1024)
            x[s:s + len(click)] += click
        return x

    def make(seed):
        e = AudioEngine(input_source=ArraySource(scene(seed)),
                        sample_rate=SR)   # no loopback -> timeout at 2 s
        e.start_tuner()
        onset = e.start_onset_detection()
        return e, onset

    slot_s = 1024 / SR
    n = int(2.8 / slot_s)
    members = [make(s) for s in (5, 6)]
    pool = EnginePool([e for e, _ in members], pipeline_depth=0,
                      aggregate_slots=1)
    ev = [[], []]
    for _ in range(n):
        pool.step_wave()
        for k, (_, onset) in enumerate(members):
            ev[k].extend(json.loads(onset.poll_onsets()))
    pool.flush()
    for k, (_, onset) in enumerate(members):
        ev[k].extend(json.loads(onset.poll_onsets()))

    for k, seed in enumerate((5, 6)):
        e_solo, onset_solo = make(seed)
        sev = []
        for _ in range(n):
            e_solo.advance(slot_s)
            sev.extend(json.loads(onset_solo.poll_onsets()))
        e_solo.flush_analysis()
        sev.extend(json.loads(onset_solo.poll_onsets()))
        assert len(sev) >= 3, "scene must fire onsets around the timeout"
        assert ev[k] == sev, f"engine {k}"
        _assert_states_match(e_solo, members[k][0])
    assert pool._rollbacks == 2
