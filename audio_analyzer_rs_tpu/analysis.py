"""One-call buffer analysis: audio in → per-frame feature structs out.

The BASELINE mandates the public analyze-buffer API: a mono buffer goes in,
per-frame feature structs come out (spectrogram, RMS/energy, centroid,
rolloff, flux, polyphonic pitches, stable pitches, onsets, YIN f0).  This is
the batch/offline face of the same kernels the streaming engine uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from .models.analyzer import OnsetAnalyzer, PitchAnalyzer
from .ops.features import feature_pack
from .ops.stft import (DEFAULT_BACKEND, ONSET_HOP, ONSET_WINDOW,
                       PITCH_BACKEND, PITCH_HOP, PITCH_WINDOW, windowed_mags)
from .ops.yin import yin_pitch
from .utils.framing import frame_signal, num_frames


@dataclass
class FrameFeatures:
    """Per-frame feature struct (one pitch-geometry frame)."""
    time_s: float
    rms: float
    energy: float
    centroid_hz: float
    rolloff_hz: float
    flux: float
    yin_f0_hz: float
    yin_voiced: bool
    pitches: List[tuple]          # raw (freq, score) up to 8
    stable_pitches: List[tuple]   # hysteresis-stable (freq, score)


@dataclass
class AnalysisResult:
    sample_rate: float
    frames: List[FrameFeatures]
    spectrogram: np.ndarray       # [N, 1025] magnitudes
    onsets: List[dict]            # {"time_s", "frame", "velocity"}

    def to_dicts(self) -> List[dict]:
        return [vars(f) for f in self.frames]


@dataclass
class AnalysisArrays:
    """Columnar variant of AnalysisResult: every per-frame feature as one
    array over all N frames — the natural shape for numpy/pandas consumers.
    Skips the per-frame struct loop (~0.14 ms/frame of Python; a minute of
    wall-clock saved on an hour-long recording)."""
    sample_rate: float
    time_s: np.ndarray            # [N]
    rms: np.ndarray               # [N]
    energy: np.ndarray            # [N]
    centroid_hz: np.ndarray       # [N]
    rolloff_hz: np.ndarray        # [N]
    flux: np.ndarray              # [N]
    yin_f0_hz: np.ndarray         # [N]
    yin_voiced: np.ndarray        # [N] bool
    raw_freqs: np.ndarray         # [N, 8]
    raw_scores: np.ndarray        # [N, 8]
    raw_valid: np.ndarray         # [N, 8] bool
    stable_freqs: np.ndarray      # [N, 8]
    stable_scores: np.ndarray     # [N, 8]
    stable_valid: np.ndarray      # [N, 8] bool
    spectrogram: np.ndarray       # [N, 1025]
    onsets: List[dict]            # {"time_s", "frame", "velocity"}


def _onset_events(fired: np.ndarray, velocity: np.ndarray,
                  sample_rate: float) -> List[dict]:
    """Onset frame flags → event dicts (shared frame→time convention)."""
    return [{"time_s": (int(i) * ONSET_HOP + ONSET_WINDOW // 2) / sample_rate,
             "frame": int(i), "velocity": float(velocity[i])}
            for i in np.flatnonzero(fired)]


def analyze_buffer(audio: np.ndarray, sample_rate: float,
                   backend: str = DEFAULT_BACKEND,
                   global_floor_db: float = -96.0,
                   as_arrays: bool = False):
    """Analyze a mono buffer (float32, or int16 scaled by 1/32768 like
    utils.wav) with the full device pipeline.

    Returns AnalysisResult (a list of per-frame structs) by default, or the
    columnar AnalysisArrays when `as_arrays=True`.

    `backend` must produce the full [N, W//2+1] spectrum (the default does):
    this rich path reuses the pitch pipeline's magnitudes for the
    spectrogram and feature pack, so the candidate-banded pitch backend
    (ops.stft.PITCH_BACKEND) doesn't apply here."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / np.float32(32768.0)
    audio = audio.astype(np.float32, copy=False)
    pa = PitchAnalyzer(sample_rate, backend=backend)
    out = pa.process(audio, global_floor_db=global_floor_db)
    n = 0 if out is None else len(out.mags)

    oa = OnsetAnalyzer(sample_rate, backend=backend)
    oout = oa.process(audio, global_floor_db=global_floor_db)

    onsets: List[dict] = ([] if oout is None else
                          _onset_events(oout.fired, oout.velocity, sample_rate))

    frames: List[FrameFeatures] = []
    feats = yin = None
    if n:
        # Device-resident: framing is a cheap gather; never pull the
        # [N, window] expansion to host.
        f = frame_signal(jnp.asarray(audio), PITCH_WINDOW, PITCH_HOP)
        feats = jax.tree.map(np.asarray, feature_pack(
            f, jnp.asarray(out.mags), sample_rate, PITCH_WINDOW))
        yin = jax.tree.map(np.asarray, yin_pitch(f, sample_rate))

    if as_arrays:
        def z(shape=(0,), dt=np.float32):
            return np.zeros(shape, dt)
        if not n:
            return AnalysisArrays(
                sample_rate=sample_rate, time_s=z(), rms=z(), energy=z(),
                centroid_hz=z(), rolloff_hz=z(), flux=z(), yin_f0_hz=z(),
                yin_voiced=z(dt=bool), raw_freqs=z((0, 8)),
                raw_scores=z((0, 8)), raw_valid=z((0, 8), bool),
                stable_freqs=z((0, 8)), stable_scores=z((0, 8)),
                stable_valid=z((0, 8), bool),
                spectrogram=z((0, PITCH_WINDOW // 2 + 1)), onsets=onsets)
        time_s = (np.arange(n) * PITCH_HOP + PITCH_WINDOW / 2) / sample_rate
        return AnalysisArrays(
            sample_rate=sample_rate, time_s=time_s.astype(np.float32),
            rms=feats.rms, energy=feats.energy,
            centroid_hz=feats.centroid_hz, rolloff_hz=feats.rolloff_hz,
            flux=feats.flux, yin_f0_hz=yin.f0_hz,
            yin_voiced=np.asarray(yin.voiced, bool),
            raw_freqs=out.raw_freqs, raw_scores=out.raw_scores,
            raw_valid=np.asarray(out.raw_valid, bool),
            stable_freqs=out.stable_freqs, stable_scores=out.stable_scores,
            stable_valid=np.asarray(out.stable_valid, bool),
            spectrogram=out.mags, onsets=onsets)

    if n:
        for i in range(n):
            frames.append(FrameFeatures(
                time_s=(i * PITCH_HOP + PITCH_WINDOW / 2) / sample_rate,
                rms=float(feats.rms[i]),
                energy=float(feats.energy[i]),
                centroid_hz=float(feats.centroid_hz[i]),
                rolloff_hz=float(feats.rolloff_hz[i]),
                flux=float(feats.flux[i]),
                yin_f0_hz=float(yin.f0_hz[i]),
                yin_voiced=bool(yin.voiced[i]),
                pitches=[(float(a), float(b)) for a, b, v in
                         zip(out.raw_freqs[i], out.raw_scores[i],
                             out.raw_valid[i]) if v],
                stable_pitches=[(float(a), float(b)) for a, b, v in
                                zip(out.stable_freqs[i], out.stable_scores[i],
                                    out.stable_valid[i]) if v],
            ))
    spectrogram = out.mags if n else np.zeros((0, PITCH_WINDOW // 2 + 1),
                                              np.float32)
    return AnalysisResult(sample_rate=sample_rate, frames=frames,
                          spectrogram=spectrogram, onsets=onsets)


def analyze_buffer_segmented(audio: np.ndarray, sample_rate: float,
                             segments: int | None = None,
                             backend: str | None = None,
                             global_floor_db: float = -96.0,
                             feature_chunk_frames: int = 8192
                             ) -> AnalysisArrays:
    """Columnar bulk analysis via the segment-parallel pipelines.

    The device bulk path for long recordings: stable pitches and onsets come
    from `models.segmented` (S parallel device-resident scan streams, >99%
    frame agreement with the sequential analyzers — the only stages that
    carry sequential state), while the feature pack, spectrogram, and YIN
    f0 are computed batched in bounded-memory chunks.  Raw
    (pre-hysteresis) pitch candidates are not produced in this mode:
    `raw_*` arrays are empty.  ~Sx faster than `analyze_buffer` on
    hour-scale audio.

    `backend=None` (default) routes each stage to its measured-fastest
    backend: the pitch pass uses the candidate-banded rDFT
    (ops.stft.PITCH_BACKEND) while the onset pass and the full-spectrum
    feature/spectrogram chunks use ops.fft.DEFAULT_BACKEND.  Passing an
    explicit backend forces it for every stage.
    """
    import jax.numpy as jnp

    from .models.segmented import (_as_host_audio, _upload_f32,
                                   segmented_onset_analysis,
                                   segmented_pitch_analysis)

    # int16 input is accepted and uploaded raw (half the host→device
    # bytes; converted on device, bit-identical to host conversion).  The
    # upload happens exactly ONCE — it dominates end-to-end for long
    # recordings, so the onset/pitch segmented passes and the feature loop
    # all share the same device-resident array.
    audio = _as_host_audio(audio)
    audio_dev = _upload_f32(audio)
    n = num_frames(len(audio), PITCH_WINDOW, PITCH_HOP)

    pitch_backend = backend or PITCH_BACKEND
    full_backend = backend or DEFAULT_BACKEND
    fired, vel, _, _ = segmented_onset_analysis(
        audio, sample_rate, segments=segments, backend=full_backend,
        global_floor_db=global_floor_db, device_audio=audio_dev)
    onsets = _onset_events(fired, vel, sample_rate)

    def z(shape=(0,), dt=np.float32):
        return np.zeros(shape, dt)
    if not n:
        return AnalysisArrays(
            sample_rate=sample_rate, time_s=z(), rms=z(), energy=z(),
            centroid_hz=z(), rolloff_hz=z(), flux=z(), yin_f0_hz=z(),
            yin_voiced=z(dt=bool), raw_freqs=z((0, 8)),
            raw_scores=z((0, 8)), raw_valid=z((0, 8), bool),
            stable_freqs=z((0, 8)), stable_scores=z((0, 8)),
            stable_valid=z((0, 8), bool),
            spectrogram=z((0, PITCH_WINDOW // 2 + 1)), onsets=onsets)

    sf, ss, sv = segmented_pitch_analysis(
        audio, sample_rate, segments=segments, backend=pitch_backend,
        global_floor_db=global_floor_db, device_audio=audio_dev)

    # Stateless per-frame stages, chunked to bound device memory (an hour of
    # audio framed at once is ~2.5 GB; YIN's padded FFT doubles that).  Each
    # chunk after the first carries one lead frame so spectral flux stays
    # continuous across the boundary (feature_pack's first row diffs against
    # zeros, which is only correct for frame 0); the lead row is dropped.
    # The last chunk is zero-padded to the common length so every chunk after
    # the first compiles one program shape.
    cols = {k: [] for k in ("rms", "energy", "centroid_hz", "rolloff_hz",
                            "flux", "f0", "voiced")}
    specs = []
    step = feature_chunk_frames
    for c0 in range(0, n, step):
        c1 = min(c0 + step, n)
        lead = 1 if c0 else 0
        m = c1 - c0
        s0 = (c0 - lead) * PITCH_HOP
        s1 = s0 + (lead + step - 1) * PITCH_HOP + PITCH_WINDOW if c0 else \
            (c1 - 1) * PITCH_HOP + PITCH_WINDOW
        sl = audio_dev[s0:min(s1, len(audio))]
        if c0 and s1 > len(audio):
            sl = jnp.pad(sl, (0, s1 - len(audio)))
        f = frame_signal(sl, PITCH_WINDOW, PITCH_HOP)
        mags = windowed_mags(f, PITCH_WINDOW, backend=full_backend)
        feats = feature_pack(f, mags, sample_rate, PITCH_WINDOW)
        y = yin_pitch(f, sample_rate)
        lo, hi = lead, lead + m
        specs.append(np.asarray(mags[lo:hi]))
        cols["rms"].append(np.asarray(feats.rms[lo:hi]))
        cols["energy"].append(np.asarray(feats.energy[lo:hi]))
        cols["centroid_hz"].append(np.asarray(feats.centroid_hz[lo:hi]))
        cols["rolloff_hz"].append(np.asarray(feats.rolloff_hz[lo:hi]))
        cols["flux"].append(np.asarray(feats.flux[lo:hi]))
        cols["f0"].append(np.asarray(y.f0_hz[lo:hi]))
        cols["voiced"].append(np.asarray(y.voiced[lo:hi]))

    time_s = (np.arange(n) * PITCH_HOP + PITCH_WINDOW / 2) / sample_rate
    return AnalysisArrays(
        sample_rate=sample_rate, time_s=time_s.astype(np.float32),
        rms=np.concatenate(cols["rms"]),
        energy=np.concatenate(cols["energy"]),
        centroid_hz=np.concatenate(cols["centroid_hz"]),
        rolloff_hz=np.concatenate(cols["rolloff_hz"]),
        flux=np.concatenate(cols["flux"]),
        yin_f0_hz=np.concatenate(cols["f0"]),
        yin_voiced=np.concatenate(cols["voiced"]).astype(bool),
        raw_freqs=z((0, 8)), raw_scores=z((0, 8)),
        raw_valid=z((0, 8), bool),
        stable_freqs=sf, stable_scores=ss,
        stable_valid=np.asarray(sv, bool),
        spectrogram=np.concatenate(specs), onsets=onsets)
