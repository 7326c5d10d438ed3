"""chip_smoke.py's helpers, on the CPU: the device check refuses anything
but a GPU, the compile cache follows JAX_COMPILATION_CACHE_DIR or the
fixed repo path, the last line is the JSON contract, and the script fails
without printing a result where the repo is absent."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


class _Dev:
    def __init__(self, platform="gpu", kind="NVIDIA H100 80GB HBM3"):
        self.platform, self.device_kind = platform, kind


def test_require_gpu_refuses_the_cpu_backend():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu(jax.devices(), 1)


@pytest.mark.parametrize("n,count,ok", [(1, 1, True), (4, 4, True),
                                        (4, 1, True), (1, 4, False)])
def test_require_gpu_counts_cards(n, count, ok):
    devices = [_Dev() for _ in range(n)]
    if ok:
        chip_smoke.require_gpu(devices, count)
    else:
        with pytest.raises(SystemExit, match=f"needs {count} GPUs"):
            chip_smoke.require_gpu(devices, count)


def test_cache_dir_follows_env_else_fixed_path(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert chip_smoke.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert chip_smoke.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_is_the_contract(count):
    line = chip_smoke.last_line([_Dev() for _ in range(count)])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert "\n" not in line


def test_json_close_tolerance():
    a = {"label": "A3", "cents": 2.40001, "notes": ["A3"], "n": 3,
         "on": True}
    assert chip_smoke.json_close(a, dict(a, cents=2.4)) == []
    assert chip_smoke.json_close(a, dict(a, cents=2.6)) != []
    assert chip_smoke.json_close(a, dict(a, label="A4")) != []
    assert chip_smoke.json_close([a], [a, a]) != []


def test_stable_agreement_counts_frames():
    sf = np.array([[440.0, 0], [220.0, 330.0]], np.float32)
    sv = np.array([[True, False], [True, True]])
    assert chip_smoke.stable_agreement(sf, sv, sf, sv) == 1.0
    sf2 = sf.copy()
    sf2[1, 1] = 331.0
    assert chip_smoke.stable_agreement(sf2, sv, sf, sv) == 0.5
    # A few mHz apart across a 0.1 Hz grid line is still agreement; a
    # missing pitch is not.
    near = sf.copy()
    near[0, 0], sf[0, 0] = 440.049, 440.051
    assert chip_smoke.stable_agreement(near, sv, sf, sv) == 1.0
    fewer = sv.copy()
    fewer[1, 1] = False
    assert chip_smoke.stable_agreement(sf, fewer, sf, sv) == 0.5


def test_fails_silently_without_the_repo(tmp_path):
    """Alone in a directory, the script exits non-zero and prints no
    result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
