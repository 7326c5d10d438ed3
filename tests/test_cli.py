"""CLI harness smoke tests (component #29)."""

import os

import numpy as np
import pytest

from audio_analyzer_rs_tpu import cli
from audio_analyzer_rs_tpu.models import generators as gen
from audio_analyzer_rs_tpu.utils import wav
from audio_analyzer_rs_tpu.utils.midi import write_midi_file


@pytest.fixture
def midi_file(tmp_path):
    path = str(tmp_path / "ref.mid")
    # Two measures so the first ages out and metrics are non-empty.
    write_midi_file(path, [(60, 0.0, 0.9, 90), (64, 1.0, 0.9, 90),
                           (67, 2.0, 0.9, 90), (72, 3.0, 0.9, 90),
                           (72, 4.0, 0.9, 90), (67, 5.0, 0.9, 90)],
                    bpm=120.0)
    return path


def test_cli_met_renders_wav(tmp_path, capsys):
    out = str(tmp_path / "met.wav")
    cli.main(["met", "120", "2", out])
    data, sr, ch = wav.read_wav(out)
    assert len(data) > 0 and np.abs(data).max() > 0.1
    assert "wrote" in capsys.readouterr().out


def test_cli_synth_renders_midi(tmp_path, midi_file, capsys):
    out = str(tmp_path / "synth.wav")
    cli.main(["synth", midi_file, out])
    data, sr, ch = wav.read_wav(out)
    assert np.abs(data).max() > 0.05
    assert "rendered" in capsys.readouterr().out


def test_cli_play_renders_file(tmp_path, capsys):
    src = str(tmp_path / "tone.wav")
    out = str(tmp_path / "played.wav")
    x = gen.tone_with_harmonics(440.0, 1.0, 44100.0, amplitude=0.4)
    wav.write_wav(src, x, 44100)
    cli.main(["play", src, out])
    data, sr, ch = wav.read_wav(out)
    # Resampled 44.1k → 48k device rate; content preserved, then silence.
    assert np.abs(data).max() > 0.2
    # Terminates promptly at track end (playback-finished detection), not
    # at the hour hard-cap.
    assert len(data) < sr * 5, len(data) / sr
    assert "played" in capsys.readouterr().out


def test_cli_onset_lists_events(tmp_path, capsys):
    path = str(tmp_path / "clicks.wav")
    x = np.zeros(int(48000 * 1.5), np.float32)
    click = gen.calibration_click(48000.0, volume=0.8)
    for t in (0.3, 0.9):
        x[int(t * 48000):int(t * 48000) + len(click)] += click
    wav.write_wav(path, x, 48000)
    cli.main(["onset", path])
    out = capsys.readouterr().out
    assert "onsets detected" in out and "velocity" in out


def test_cli_practice_full_flow(midi_file, capsys):
    cli.main(["practice", midi_file, "--mode", "Performance",
              "--ability", "Advanced"])
    out = capsys.readouterr().out
    assert "measure 0" in out
    assert "✓" in out                       # matched notes logged
    assert "accuracy" in out                # metric pretty-print
    assert "100.0%" in out or "accuracy" in out


def test_cli_unknown_command_exits(capsys):
    with pytest.raises(SystemExit):
        cli.main(["frobnicate"])


def test_cli_missing_args_usage(capsys):
    with pytest.raises(SystemExit):
        cli.main(["analyze"])
    assert "missing argument" in capsys.readouterr().out


def test_cli_analyze_jsonl(tmp_path, capsys):
    import json as json_mod

    path = str(tmp_path / "tone.wav")
    x = gen.tone_with_harmonics(220.0, 2.0, 44100.0, harmonics=6,
                                amplitude=0.35)
    wav.write_wav(path, x, 44100)
    out_path = str(tmp_path / "out.jsonl")
    cli.main(["analyze", path, out_path, "--segments", "2"])
    lines = [json_mod.loads(l) for l in open(out_path)]
    header, frames = lines[0], lines[1:]
    assert header["frames"] == len(frames)
    mid = frames[len(frames) // 2]
    assert abs(mid["yin_f0_hz"] - 220.0) < 2.0 and mid["yin_voiced"]
    assert any(abs(p[0] - 220.3) < 1 for p in mid["stable_pitches"])


def test_debug_view_renders_stream(tmp_path):
    """debug-view (the live Rerun-analog viewer): unit-feed
    the renderer, then drive the CLI command over a real recorded stream
    and over a concurrently-growing file (the tail -f path)."""
    import io
    import json
    import threading

    from audio_analyzer_rs_tpu.devtools import DebugStreamView

    # Renderer unit: pitch-set change and fired onset produce event lines;
    # the status line carries labels, floor and counts.
    v = DebugStreamView()
    ev = v.feed({"kind": "pitch", "frame": 7, "bin_width": 21.5,
                 "stable_pitches": [{"freq": 440.0, "score": 3.0,
                                     "label": "A4"}],
                 "noise_floor": [0.001] * 8})
    assert ev and "A4" in ev
    assert v.feed({"kind": "pitch", "frame": 8, "bin_width": 21.5,
                   "stable_pitches": [{"freq": 440.0, "score": 3.0,
                                       "label": "A4"}]}) is None  # unchanged
    ev = v.feed({"kind": "onset", "frame": 9, "flux": 5.0, "burst_count": 4,
                 "detected": True, "fired": True,
                 "status": "DETECTED flux=5.0 burst=4"})
    assert ev and "ONSET" in ev and v.n_fired == 1
    st = v.status_line()
    assert "A4" in st and "dB" in st and "onsets:   1" in st

    # End-to-end: record a stream via the engine flow, view it once-mode.
    path = str(tmp_path / "d.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "pitch", "frame": 1, "bin_width": 21.5,
                            "stable_pitches": [{"freq": 261.6, "score": 2.0,
                                                "label": "C4"}]}) + "\n")
        f.write(json.dumps({"kind": "onset", "frame": 2, "flux": 9.0,
                            "burst_count": 5, "detected": True,
                            "fired": True, "status": "DETECTED"}) + "\n")
    out = io.StringIO()
    cli.cmd_debug_view(path, follow=False, out=out)
    text = out.getvalue()
    assert "C4" in text and "ONSET" in text
    assert "1 pitch frames, 1 onset frames, 1 onsets fired" in text

    # Follow mode: a writer thread appends (including a torn partial line
    # that must be re-read whole); the viewer stops at EOF once the writer
    # is done.
    path2 = str(tmp_path / "live.jsonl")
    open(path2, "w").close()
    done = threading.Event()

    def writer():
        with open(path2, "a") as f:
            line = json.dumps({"kind": "pitch", "frame": 3,
                               "bin_width": 21.5,
                               "stable_pitches": [{"freq": 329.6,
                                                   "score": 1.0,
                                                   "label": "E4"}]}) + "\n"
            f.write(line[:20]); f.flush()       # torn write
            import time; time.sleep(0.1)
            f.write(line[20:]); f.flush()
            f.write(json.dumps({"kind": "onset", "frame": 4, "flux": 2.0,
                                "burst_count": 3, "detected": True,
                                "fired": True, "status": "DETECTED"}) + "\n")
        done.set()

    t = threading.Thread(target=writer)
    out2 = io.StringIO()
    t.start()
    cli.cmd_debug_view(path2, follow=True, out=out2, poll_s=0.05,
                       stop=done.is_set)
    t.join()
    text2 = out2.getvalue()
    assert "E4" in text2 and "ONSET" in text2, text2
