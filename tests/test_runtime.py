"""Native C++ runtime tests: build, ring/pool primitives, reducer parity
with the Python host path, and the threaded pipeline."""

import numpy as np
import pytest

from audio_analyzer_rs_tpu import runtime
from audio_analyzer_rs_tpu.models import generators as gen
from audio_analyzer_rs_tpu.ops.dynamics import DynamicsTrackerNp
from audio_analyzer_rs_tpu.ops.reducer import HostReducer

SR = 48000.0

pytestmark = pytest.mark.skipif(not runtime.available(),
                                reason="native runtime unavailable")


def _scene(n_slots, rng):
    slots = []
    t = np.arange(1024) / SR
    for i in range(n_slots):
        if i % 4 == 0:
            slots.append((rng.standard_normal(1024) * 1e-5).astype(np.float32))
        else:
            slots.append((0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
    return slots


def test_native_reducer_matches_python_host_path(rng):
    native = runtime.NativeReducer(SR, 1024)
    py_red = HostReducer(SR)
    py_dyn = DynamicsTrackerNp(SR, 1024)
    for slot in _scene(24, rng):
        n_out, n_d = native.process_slot(slot)
        p_cond = py_red.process(slot)
        p_d = py_dyn.process_slot(p_cond)
        assert n_d["level"] == p_d["level"]
        # C++ -O3 FMA contraction vs NumPy per-op f32 rounding drifts the IIR
        # state slowly (same class of divergence as Rust-vs-Python f32); the
        # behavioral outputs (level, gains within ~0.1 dB) must agree.
        np.testing.assert_allclose(n_d["rms_db"], p_d["rms_db"], atol=0.1)
        np.testing.assert_allclose(n_d["noise_floor_db"], p_d["noise_floor_db"],
                                   atol=0.2)
        np.testing.assert_allclose(n_d["gain_db"], p_d["gain_db"], atol=0.1)
        np.testing.assert_allclose(n_out, p_d["slot"], rtol=2e-2, atol=5e-4)


def test_native_pipeline_threaded_roundtrip(rng):
    import time
    pipe = runtime.NativePipeline(SR, pool_size=64, slot_len=1024)
    slots = _scene(32, rng)
    ref = runtime.NativeReducer(SR, 1024)
    expected = [ref.process_slot(s)[0] for s in slots]
    for s in slots:
        assert pipe.push(s)
    got = []
    deadline = time.time() + 5.0
    while len(got) < len(slots) and time.time() < deadline:
        r = pipe.pull()
        if r is None:
            time.sleep(0.001)
            continue
        got.append(r[0])
    pipe.close()
    assert len(got) == len(slots)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-7)


def test_native_pipeline_per_slot_dynamics_pairing(rng):
    """Each pulled slot must carry ITS OWN dynamics snapshot, not whichever
    slot the worker conditioned last (the pre-fix code shared one struct,
    racy and mispaired when the worker ran ahead of the consumer)."""
    import time
    pipe = runtime.NativePipeline(SR, pool_size=64, slot_len=1024)
    slots = _scene(24, rng)
    ref = runtime.NativeReducer(SR, 1024)
    expected_rms = [ref.process_slot(s)[1]["rms_db"] for s in slots]
    # Push everything first so the worker drains far ahead of our pulls —
    # exactly the window where the shared-struct version mispaired.
    for s in slots:
        assert pipe.push(s)
    deadline = time.time() + 5.0
    got = []
    while len(got) < len(slots) and time.time() < deadline:
        r = pipe.pull()
        if r is None:
            time.sleep(0.001)
            continue
        got.append(r[1]["rms_db"])
    pipe.close()
    assert len(got) == len(slots)
    np.testing.assert_allclose(got, expected_rms, atol=1e-4)


def test_stale_library_degrades_gracefully(tmp_path):
    """A corrupt .so must not crash available() (documented graceful
    degradation contract).  Run in a fresh subprocess against a temp copy:
    overwriting the real library in place while it is dlopen'd in this
    process would SIGBUS the suite."""
    import os
    import subprocess
    import sys

    (tmp_path / "libaudio_runtime.so").write_bytes(b"not an elf file")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "from audio_analyzer_rs_tpu import runtime\n"
        f"runtime._RUNTIME_DIR = {str(tmp_path)!r}\n"   # no Makefile: rebuild fails
        f"runtime._LIB_PATH = {str(tmp_path / 'libaudio_runtime.so')!r}\n"
        "assert not runtime.available()\n"              # False, not a crash
        "print('graceful')\n")
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "graceful" in proc.stdout


@pytest.mark.parametrize("sig,ok", [("this host", True),
                                    ("another host", False),
                                    (None, False)])
def test_library_built_for_another_cpu_is_not_loaded(tmp_path, monkeypatch,
                                                     sig, ok):
    """The runtime is built with -march=native: a library whose host.sig
    names another CPU (or none) counts as missing and is rebuilt before it
    is loaded."""
    lib = tmp_path / "libaudio_runtime.so"
    lib.write_bytes(b"")
    if sig is not None:
        text = runtime._host_signature() if sig == "this host" else "0" * 32
        (tmp_path / "host.sig").write_text(text + "\n")
    monkeypatch.setattr(runtime, "_RUNTIME_DIR", str(tmp_path))
    assert runtime._built_here(str(lib)) is ok


def test_native_throughput_is_realtime_many_times_over(rng):
    """The host conditioning path must not be the system bottleneck."""
    import time
    native = runtime.NativeReducer(SR, 1024)
    slot = (0.2 * np.sin(2 * np.pi * 440 * np.arange(1024) / SR)
            ).astype(np.float32)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        native.process_slot(slot)
    dt = time.perf_counter() - t0
    audio_seconds = n * 1024 / SR
    assert audio_seconds / dt > 20.0, f"only {audio_seconds/dt:.0f}x realtime"
