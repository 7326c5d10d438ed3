"""audio_analyzer_rs_tpu — a JAX rebuild of LiamWhelan1/audio-analyzer-rs.

A brand-new JAX/XLA/Pallas audio-analysis framework with the capabilities of the
Rust realtime music-practice engine (reference: /root/reference, crate
`audio_engine`).  The reference's per-sample Rust loops become batched tensor
programs over `[frames, ...]` with `jax.lax.scan` carrying the sequential state
(noise floors, trackers, AGC histories); the hot windowing+FFT inner loop has
two device backends (`jnp.fft` default, a banded GEMM rDFT for pitch);
multi-chip scale-out is data-parallel sharding of the frame/batch axis over a
`jax.sharding.Mesh`.

Layer map (mirrors SURVEY.md §1/§7):
  ops/       device kernels: fft, stft, features, pitch, onset, noisefloor,
             reducer (filter/gate/AGC), trackers       (ref: src/dsp, src/audio_io)
  models/    analyzer pipelines + signal generators    (ref: src/analysis, src/generators)
  parallel/  mesh + sharding helpers                   (no ref analog: SPMD scale-out)
  utils/     WAV io, MIDI SMF parser, framing          (ref: hound/symphonia/midly deps)
  theory     music theory                              (ref: src/analysis/theory.rs)
  transport  musical transport (deterministic)         (ref: src/audio_io/timing.rs)
  practice/  session scoring engine                    (ref: src/practice/*)
  api/       AudioEngine-shaped JSON polling surface   (ref: src/lib.rs uniffi objects)
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy re-exports of the public surface (avoid importing jax at package
    # import for light-weight consumers like the theory/MIDI helpers).
    if name == "AudioEngine":
        from .api.engine import AudioEngine
        return AudioEngine
    if name == "EnginePool":
        from .api.pool import EnginePool
        return EnginePool
    if name in ("analyze_buffer", "analyze_buffer_segmented",
                "AnalysisResult", "AnalysisArrays", "FrameFeatures"):
        from . import analysis
        return getattr(analysis, name)
    if name in ("segmented_pitch_analysis", "segmented_onset_analysis",
                "segmented_pitch_analysis_batch",
                "segmented_onset_analysis_batch"):
        from .models import segmented
        return getattr(segmented, name)
    if name in ("decode_file", "encode_file", "decode_available"):
        from . import runtime
        return getattr(runtime, name)
    if name == "PitchAnalyzer":
        from .models.analyzer import PitchAnalyzer
        return PitchAnalyzer
    if name == "OnsetAnalyzer":
        from .models.analyzer import OnsetAnalyzer
        return OnsetAnalyzer
    if name == "MusicalTransport":
        from .transport import MusicalTransport
        return MusicalTransport
    raise AttributeError(name)
