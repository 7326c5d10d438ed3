"""Polyphonic pitch extraction: peaks → parabolic interp → harmonic comb.

Vectorized port of `STFT::extract_pitches` (ref src/audio_io/stft.rs:443-620).
The reference walks a Vec of peak bins with data-dependent loops; here every
bin is scored in parallel (masked to peaks), the 13-harmonic comb is an
unrolled loop of [H]-wide vector ops, and the data-dependent candidate list
becomes a fixed top-K + masked greedy dedup — static shapes for XLA.

Constants (ref stft.rs:452-453,536-543,594,606):
  MAX_HARMONICS=14, MAX_NOTES=8, fund gate 5x floor, structure gate
  (longest_run<3 && fund<15x floor), cutoff 50% of max score, ghost ratios
  2..5 at 3% tol / 5% score margin, dedup separation 2.0 bins.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_HARMONICS = 14
MAX_NOTES = 8
TOP_K = 32  # static candidate cap; the reference's Vec is unbounded but
            # >32 peaks above half-max-score does not occur in practice.
# Offsets per stacked slab in the harmonic comb.  8 keeps the
# [batch, frames, chunk, kc] transient ~4x smaller than one slab per
# harmonic window (31); carried over from an earlier build, not re-swept
# on the H100.  The cross-chunk strict-greater select chain keeps
# first-max semantics at any chunk size (bit-exact; oracle fuzz tests pin
# it).
_COMB_CHUNK = 8

MIN_FREQ = 24.0      # ref stft.rs:173
MAX_FREQ = 10_000.0  # ref stft.rs:174


class PitchFrame(NamedTuple):
    freqs: jax.Array   # [MAX_NOTES] float32
    scores: jax.Array  # [MAX_NOTES] float32
    valid: jax.Array   # [MAX_NOTES] bool


def _comb_xla(pm: jax.Array, frac_c: jax.Array, fund_mag: jax.Array,
              half: int, max_bin: int | None = None):
    """One frame's harmonic-comb loop (ref stft.rs:499-545): pm [kc]
    (peak-masked magnitudes), frac_c [kc] fractional bins, fund_mag [kc]
    score seed → (score [kc] = fund + Σ best harmonic mags in the
    reference's accumulation order, longest_run [kc] i32, total_harms [kc]
    i32).  See the restructuring notes in `_extract_single`.

    `max_bin`: exclusive upper bound of peak bins (the 10 kHz cap,
    ref stft.rs:455,463).  Harmonic matches must themselves be peaks
    (is_peak[h], stft.rs:517-521), so bins >= max_bin can never match."""
    kc = pm.shape[0]
    if max_bin is None:
        max_bin = kc
    k_c = jnp.arange(kc, dtype=jnp.int32)
    front = MAX_HARMONICS + 2
    # Candidate truncation (bit-exact, two bounds per harmonic n):
    #  (a) existence: expected = frac*n >= (j-1)*n, so j >= half//n + 2
    #      implies expected >= half and the reference breaks (valid_n
    #      false ⇒ the state update below is the identity);
    #  (b) matchability: peaks only exist below max_bin, and the search
    #      window starts at floor(expected-1) >= (j-1)*n - 1, so
    #      j >= max_bin//n + 3 guarantees the window holds only zeros —
    #      a MISS, whose only state effect is the run reset applied by
    #      the tail mask below (no slab reads needed).
    # Computing each harmonic only on its matchable prefix cuts the slab
    # reads ~2x again over bound (a) alone and shrinks the padded read
    # array from ~half to ~max_bin lanes.
    kcn_of = {n: min(kc, half // n + 2, max_bin // n + 3)
              for n in range(2, MAX_HARMONICS + 1)}
    pad_len = front + max(max(kcn_of[n] * n + n + 2
                              for n in range(2, MAX_HARMONICS + 1)),
                          kc + 1)
    pm_pad = jnp.zeros((pad_len,), jnp.float32).at[front:front + kc].set(pm)

    score = fund_mag
    last = k_c
    longest_run = jnp.zeros((kc,), jnp.int32)
    current_run = jnp.zeros((kc,), jnp.int32)
    total_harms = jnp.zeros((kc,), jnp.int32)
    for n in range(2, MAX_HARMONICS + 1):
        kcn = kcn_of[n]
        k_n = k_c[:kcn]
        expected_f = frac_c[:kcn] * n
        valid_n = expected_f < half
        search_base = jnp.floor(expected_f - 1.0).astype(jnp.int32)
        search_start = jnp.maximum(search_base, last[:kcn] + 1)
        search_end = jnp.minimum(jnp.ceil(expected_f + 1.0).astype(jnp.int32), half - 1)
        # Window values for offsets c as stacked static strided slices;
        # bounds become a broadcast band mask.  The stack is chunked to
        # _COMB_CHUNK offsets so the transient under frame/segment vmap is
        # [batch, frames, _COMB_CHUNK, half] instead of [.., 2n+3, ..] —
        # ~4x less HBM at n=14, which is what allows >16 parallel segment
        # streams per chip.  Across chunks a short strict-> select chain
        # keeps the FIRST (lowest-c) maximum, exactly like the Rust
        # ascending scan (ref stft.rs:517-528); within a chunk argmax
        # already returns the first maximum.  (A fully unrolled running max
        # — 247 select rounds — compiles pathologically under vmap on this
        # backend; ~5 rounds per harmonic is fine.)
        cs_py = list(range(-n - 1, n + 2))
        nk = n * k_n
        best_mag = jnp.zeros((kcn,), jnp.float32)
        best_c = jnp.zeros((kcn,), jnp.int32)
        for lo in range(0, len(cs_py), _COMB_CHUNK):
            chunk = cs_py[lo:lo + _COMB_CHUNK]
            cs = jnp.asarray(chunk, dtype=jnp.int32)
            vals = jnp.stack([
                jax.lax.slice(pm_pad, (front + c,),
                              (front + c + kcn * n,), (n,))
                for c in chunk], axis=0)                      # [<=CHUNK, kcn]
            in_band = ((nk[None, :] + cs[:, None] >= search_start[None, :])
                       & (nk[None, :] + cs[:, None] <= search_end[None, :]))
            masked = jnp.where(in_band, vals, 0.0)
            cmax = jnp.max(masked, axis=0)
            carg = jnp.argmax(masked, axis=0).astype(jnp.int32)
            better = cmax > best_mag                          # strict: first wins
            best_mag = jnp.where(better, cmax, best_mag)
            best_c = jnp.where(better, carg + lo, best_c)
        best_h = nk + best_c - n - 1
        found = best_mag > 0.0                                # strict-positive
        found_eff = found & valid_n
        miss = (~found) & valid_n

        def _splice(new_prefix, old):
            # Candidates >= kcn have valid_n false ⇒ identity update.
            if kcn < kc:
                return jnp.concatenate([new_prefix, old[kcn:]])
            return new_prefix
        score = _splice(score[:kcn] + jnp.where(found_eff, best_mag, 0.0),
                        score)
        last = _splice(jnp.where(found_eff, best_h, last[:kcn]), last)
        longest_run = _splice(
            jnp.where(miss, jnp.maximum(longest_run[:kcn], current_run[:kcn]),
                      longest_run[:kcn]), longest_run)
        current_run = _splice(
            jnp.where(found_eff, current_run[:kcn] + 1,
                      jnp.where(miss, 0, current_run[:kcn])), current_run)
        total_harms = _splice(total_harms[:kcn] + found_eff.astype(jnp.int32),
                              total_harms)
        if kcn < kc:
            # Tail candidates past the matchable prefix (bound (b)) whose
            # harmonic still exists (expected < half) take the reference's
            # miss branch: run reset only (stft.rs:527-531).
            tail_miss = (k_c >= kcn) & (frac_c * n < half)
            longest_run = jnp.where(
                tail_miss, jnp.maximum(longest_run, current_run), longest_run)
            current_run = jnp.where(tail_miss, 0, current_run)
    longest_run = jnp.maximum(longest_run, current_run)
    return score, longest_run, total_harms


def _comb_fminor(pm: jax.Array, frac_c: jax.Array, fund_mag: jax.Array,
                 half: int, max_bin: int):
    """Batched frames-MINOR harmonic comb: pm/frac_c/fund_mag [N, kc] →
    (score, longest_run, total_harms) [N, kc].  Bit-exact reformulation of
    `_comb_xla` (same truncation bounds, same chunked first-max argmax,
    same tail-miss mask) operating on the whole frame batch at once.

    Why: `_comb_xla`'s stride-n slices stride the minor axis, so the
    hardware may read ~n times the nominal slab.  Transposing once per
    call to pm_T [pad_bins, N] puts candidates on the major axis, so each
    stride-n slice reads whole contiguous rows.  `DEFAULT_COMB` remains
    "xla"; neither is measured on the H100 (ROADMAP 3.2)."""
    n_frames = pm.shape[0]
    kc = pm.shape[1]
    front = MAX_HARMONICS + 2
    kcn_of = {n: min(kc, half // n + 2, max_bin // n + 3)
              for n in range(2, MAX_HARMONICS + 1)}
    pad_len = front + max(max(kcn_of[n] * n + n + 2
                              for n in range(2, MAX_HARMONICS + 1)),
                          kc + 1)
    pmT = jnp.zeros((pad_len, n_frames), jnp.float32
                    ).at[front:front + kc, :].set(pm.T)
    fracT = frac_c.T                                   # [kc, N]
    k_c = jnp.arange(kc, dtype=jnp.int32)
    score = fund_mag.T
    last = jnp.broadcast_to(k_c[:, None], (kc, n_frames))
    longest_run = jnp.zeros((kc, n_frames), jnp.int32)
    current_run = jnp.zeros((kc, n_frames), jnp.int32)
    total_harms = jnp.zeros((kc, n_frames), jnp.int32)
    for n in range(2, MAX_HARMONICS + 1):
        kcn = kcn_of[n]
        expected_f = fracT[:kcn] * n
        valid_n = expected_f < half
        search_base = jnp.floor(expected_f - 1.0).astype(jnp.int32)
        search_start = jnp.maximum(search_base, last[:kcn] + 1)
        search_end = jnp.minimum(
            jnp.ceil(expected_f + 1.0).astype(jnp.int32), half - 1)
        nk = (n * k_c[:kcn])[:, None]                  # [kcn, 1]
        cs_py = list(range(-n - 1, n + 2))
        best_mag = jnp.zeros((kcn, n_frames), jnp.float32)
        best_c = jnp.zeros((kcn, n_frames), jnp.int32)
        for lo in range(0, len(cs_py), _COMB_CHUNK):
            chunk = cs_py[lo:lo + _COMB_CHUNK]
            cs = jnp.asarray(chunk, dtype=jnp.int32)
            vals = jnp.stack([
                jax.lax.slice(pmT, (front + c, 0),
                              (front + c + kcn * n, n_frames), (n, 1))
                for c in chunk], axis=0)               # [<=CHUNK, kcn, N]
            pos = nk[None] + cs[:, None, None]
            in_band = ((pos >= search_start[None])
                       & (pos <= search_end[None]))
            masked = jnp.where(in_band, vals, 0.0)
            cmax = jnp.max(masked, axis=0)
            carg = jnp.argmax(masked, axis=0).astype(jnp.int32)
            better = cmax > best_mag                   # strict: first wins
            best_mag = jnp.where(better, cmax, best_mag)
            best_c = jnp.where(better, carg + lo, best_c)
        best_h = nk + best_c - n - 1
        found = best_mag > 0.0
        found_eff = found & valid_n
        miss = (~found) & valid_n

        def _splice(new_prefix, old):
            if kcn < kc:
                return jnp.concatenate([new_prefix, old[kcn:]], axis=0)
            return new_prefix
        score = _splice(score[:kcn] + jnp.where(found_eff, best_mag, 0.0),
                        score)
        last = _splice(jnp.where(found_eff, best_h, last[:kcn]), last)
        longest_run = _splice(
            jnp.where(miss, jnp.maximum(longest_run[:kcn], current_run[:kcn]),
                      longest_run[:kcn]), longest_run)
        current_run = _splice(
            jnp.where(found_eff, current_run[:kcn] + 1,
                      jnp.where(miss, 0, current_run[:kcn])), current_run)
        total_harms = _splice(
            total_harms[:kcn] + found_eff.astype(jnp.int32), total_harms)
        if kcn < kc:
            tail_miss = (k_c[:, None] >= kcn) & (fracT * n < half)
            longest_run = jnp.where(
                tail_miss, jnp.maximum(longest_run, current_run), longest_run)
            current_run = jnp.where(tail_miss, 0, current_run)
    longest_run = jnp.maximum(longest_run, current_run)
    return score.T, longest_run.T, total_harms.T


def _pre_comb(mags: jax.Array, nf_c: jax.Array, min_bin: int, max_bin: int,
              kc: int):
    """One frame's pre-comb stage on the [kc] candidate band: local peaks
    above the floor (ref stft.rs:461-469) + parabolic sub-bin interpolation
    in log magnitude (ref stft.rs:484-497).  Returns
    (pm [kc] peak-masked mags, frac_c [kc] fractional bins, m_c [kc],
    is_peak [kc], degenerate [kc])."""
    k_c = jnp.arange(kc, dtype=jnp.int32)
    m_c = mags[:kc]

    m_l = jnp.concatenate([m_c[:1], m_c[:-1]])
    m_r = mags[1:kc + 1]
    in_range = (k_c >= min_bin + 1) & (k_c < max_bin)
    is_peak = in_range & (m_c > nf_c) & (m_c >= m_l) & (m_c >= m_r)

    y = jnp.log(m_c)
    y_l = jnp.concatenate([y[:1], y[:-1]])
    y_r = jnp.log(mags[1:kc + 1])
    denom = y_l - 2.0 * y + y_r
    delta = jnp.where(jnp.abs(denom) < 1e-30, 0.0,
                      jnp.clip(0.5 * (y_l - y_r) / denom, -1.0, 1.0))
    # A peak with an exactly-zero neighbor makes ln() produce NaN through
    # the interpolation; the reference's NaN propagates until the final
    # freq-range filter silently drops the candidate (NaN comparisons are
    # false).  We zero such peaks' scores up front instead — same net
    # output, no NaN-dependent int conversions (only reachable on
    # synthetic spectra; real FFT magnitudes are never exactly 0 beside a
    # peak).
    degenerate = ~jnp.isfinite(delta)
    delta = jnp.where(degenerate, 0.0, delta)
    frac_c = k_c.astype(jnp.float32) + delta
    pm = jnp.where(is_peak, m_c, 0.0)
    return pm, frac_c, m_c, is_peak, degenerate


def _extract_single(mags: jax.Array, noise_floor: jax.Array,
                    bin_width: float, min_bin: int, max_bin: int,
                    min_freq: float, max_freq: float,
                    comb_outs=None, true_half: int | None = None) -> PitchFrame:
    """One frame: mags [H or >=kc+1], floor [>=kc] → up to 8 (freq, score).

    Everything except the padded harmonic-read spectrum runs on the [kc]
    candidate band (kc ≈ the 10 kHz bin): peaks, interpolation, comb
    state, gates, and top-k.  Bins at/above max_bin can never be peaks —
    and the reference requires harmonic matches to be peaks too
    (ref stft.rs:517-521) — so outputs are bit-identical to full-width.
    `noise_floor` may be the full [H] floor or just its [kc] prefix (the
    banded noise-floor scan); `mags` may likewise be banded to kc+1 bins
    (a banded rDFT), in which case `true_half` carries the real spectrum
    width W//2+1 (the comb's harmonic-existence bound, which must not
    shrink with the band)."""
    half = true_half if true_half is not None else mags.shape[0]
    # Static candidate band width; at least TOP_K so the top_k below is
    # well-formed, at most half-1 so the right-neighbor shift stays in
    # bounds (max_bin <= half-2 guarantees masked-out extras only).
    kc = min(half - 1, max(max_bin, TOP_K))
    nf_c = noise_floor[:kc]
    pm, frac_c, m_c, is_peak, degenerate = _pre_comb(mags, nf_c, min_bin,
                                                     max_bin, kc)

    # ── harmonic comb scoring, all candidate bins in parallel
    # (stft.rs:499-545).  Gather-free restructure: dynamic gathers (mags
    # at per-bin search windows) lower poorly on accelerators.  Since
    # the window for harmonic n of bin k is centered at n*k (frac_bin
    # deviates from k by at most ±1, so e = frac*n lies within ±n of n*k),
    # every needed value pm[n*k + c] for c in [-n-1, n+1] is a *static
    # strided slice* of a zero-padded peak-magnitude array — no gathers at
    # all.  The dynamic fractional window [e-1, e+1] and the "past the last
    # matched bin" constraint become pure arithmetic masks on the static
    # position n*k+c.
    #
    # Only bins below max_bin can be fundamentals (is_peak requires
    # k < max_bin, the 10 kHz cap — bin ~464 of 1025 at 44.1 kHz/2048), so
    # the comb runs on the [kc] candidate band only: ~2.2x less compute and
    # HBM slab than full-width, with harmonics still read from the full
    # padded spectrum.
    fund_mag = m_c
    if comb_outs is not None:
        # Batched comb ran outside the per-frame vmap (comb="fminor"; see
        # extract_pitches).
        score, longest_run, total_harms = comb_outs
    else:
        score, longest_run, total_harms = _comb_xla(pm, frac_c, fund_mag,
                                                    half, max_bin)

    # Gates (stft.rs:479-481,536-544) — all on the [kc] candidate band.
    low_fund = fund_mag < nf_c * 5.0
    struct_fail = (longest_run < 3) & (fund_mag < 15.0 * nf_c)
    log_score = jnp.log2(0.5 + score)
    struct_mult = (1.0 + longest_run.astype(jnp.float32)
                   + total_harms.astype(jnp.float32) / 2.0) / (1.0 + MAX_HARMONICS)
    scores = jnp.where(is_peak & ~low_fund & ~struct_fail & ~degenerate,
                       log_score * struct_mult, 0.0)

    # ── cutoff at 50% of max (stft.rs:547-562) ──────────────────────────
    peak_scores = jnp.where(is_peak, scores, 0.0)
    max_score = jnp.max(jnp.maximum(peak_scores, 0.0))
    cutoff = max_score * 0.5
    cand_mask = is_peak & (scores >= cutoff) & (max_score > 0.0)

    # Top-K by score (desc, ties → lower bin) — stands in for the sort.
    top_vals, top_idx = jax.lax.top_k(jnp.where(cand_mask, scores, -jnp.inf), TOP_K)
    cvalid = top_vals > -jnp.inf
    # Gather-free payload pickup: frac_c[top_idx] as a masked one-hot
    # reduction instead of a [K]-wide `take_along_axis` gather; the
    # broadcast-compare+select fuses into the sum's
    # reduction loop (no [K, kc] materialization, no gather lowering) and
    # selects the identical f32 value (one-hot ⇒ the sum has exactly one
    # contributor; +0.0 elsewhere is exact).
    iota_c = jnp.arange(frac_c.shape[0], dtype=jnp.int32)
    cfrac = jnp.sum(jnp.where(top_idx[:, None] == iota_c[None, :],
                              frac_c[None, :], 0.0), axis=-1)
    cfreq = cfrac * bin_width

    # ── harmonic-ghost suppression (stft.rs:564-589) ─────────────────────
    ratio = cfreq[:, None] / jnp.maximum(cfreq[None, :], 1e-30)
    nearest = jnp.round(ratio)
    eye = jnp.eye(TOP_K, dtype=bool)
    ghost = (cvalid[:, None] & cvalid[None, :] & ~eye
             & (nearest >= 2.0) & (nearest <= 5.0)
             & (jnp.abs(ratio / jnp.maximum(nearest, 1e-30) - 1.0) < 0.03)
             & (top_vals[:, None] < top_vals[None, :] * 1.05))
    suppressed = jnp.any(ghost, axis=1)
    cvalid = cvalid & ~suppressed

    # ── greedy dedup by 2-bin separation, score-desc order (stft.rs:594-605)
    def dedup_body(i, kept):
        conflict = jnp.any(kept & (jnp.abs(cfrac - cfrac[i]) < 2.0))
        return kept.at[i].set(cvalid[i] & ~conflict)
    kept = jax.lax.fori_loop(0, TOP_K, dedup_body,
                             jnp.zeros((TOP_K,), dtype=bool))

    # ── take first MAX_NOTES kept, in score order (stft.rs:606-619) ─────
    rank = jnp.cumsum(kept.astype(jnp.int32)) - 1
    slot = jnp.where(kept & (rank < MAX_NOTES), rank, MAX_NOTES)
    out_freq = jnp.zeros((MAX_NOTES + 1,), jnp.float32).at[slot].set(cfreq)[:MAX_NOTES]
    out_score = jnp.zeros((MAX_NOTES + 1,), jnp.float32).at[slot].set(top_vals)[:MAX_NOTES]
    out_valid = jnp.zeros((MAX_NOTES + 1,), bool).at[slot].set(kept)[:MAX_NOTES]
    # Final frequency-range filter.
    out_valid = out_valid & (out_freq >= min_freq) & (out_freq <= max_freq)
    return PitchFrame(out_freq, out_score, out_valid)


def candidate_band(bin_width: float, half: int,
                   max_freq: float = MAX_FREQ) -> int:
    """Static width of the fundamental-candidate band (the `kc` of
    `_extract_single`): the noise-floor scan only needs to run on this many
    bins because floors at/above it are unobservable in pitch extraction."""
    max_bin = min(int(np.floor(max_freq / bin_width)), half - 2)
    return min(half - 1, max(max_bin, TOP_K))


# Comb backend: "xla" (per-frame chunked strided-slice stacks vmapped over
# frames — the default) or "fminor" (batched frames-minor layout, see
# _comb_fminor).  Bit-exact to each other; module default used by
# extract_pitches.
DEFAULT_COMB = "xla"
COMBS = ("xla", "fminor")


@partial(jax.jit, static_argnames=("bin_width", "min_freq", "max_freq",
                                   "comb", "true_half"))
def extract_pitches(mags: jax.Array, noise_floor: jax.Array,
                    bin_width: float, min_freq: float = MIN_FREQ,
                    max_freq: float = MAX_FREQ,
                    comb: str | None = None,
                    true_half: int | None = None) -> PitchFrame:
    """Batched pitch extraction: mags [N, H] (or [N, kc+1] banded, with
    `true_half` = the real W//2+1), floor [N, H] or [N, kc]
    (see `candidate_band`) → PitchFrame [N, 8]."""
    half = true_half if true_half is not None else mags.shape[-1]
    min_bin = max(int(np.ceil(min_freq / bin_width)), 1)
    max_bin = min(int(np.floor(max_freq / bin_width)), half - 2)
    comb = DEFAULT_COMB if comb is None else comb
    fn = partial(_extract_single, bin_width=bin_width, min_bin=min_bin,
                 max_bin=max_bin, min_freq=min_freq, max_freq=max_freq,
                 true_half=half)
    if comb not in COMBS:
        raise ValueError(f"comb={comb!r}: expected one of {COMBS}")
    if comb == "fminor":
        kc = min(half - 1, max(max_bin, TOP_K))
        pm, frac_c, m_c, _, _ = jax.vmap(
            partial(_pre_comb, min_bin=min_bin, max_bin=max_bin, kc=kc)
        )(mags, noise_floor[:, :kc])
        comb_outs = _comb_fminor(pm, frac_c, m_c, half, max_bin)
        return jax.vmap(lambda m, f, co: fn(m, f, comb_outs=co))(
            mags, noise_floor, comb_outs)
    return jax.vmap(fn)(mags, noise_floor)


# ── NumPy oracle: direct transcription of the Rust algorithm ─────────────

def extract_pitches_np(magnitudes: np.ndarray, noise_floor: np.ndarray,
                       bin_width: float, min_freq: float = MIN_FREQ,
                       max_freq: float = MAX_FREQ):
    """Loop-for-loop float32 transcription of stft.rs:443-620 for parity tests.

    Returns a list of (freq, score) like the Rust Vec.
    """
    half = len(magnitudes)
    magnitudes = magnitudes.astype(np.float32)
    noise_floor = noise_floor.astype(np.float32)
    min_bin = max(int(np.ceil(min_freq / bin_width)), 1)
    max_bin = min(int(np.floor(max_freq / bin_width)), half - 2)
    if min_bin >= max_bin:
        return []

    is_peak = np.zeros(half, dtype=bool)
    peak_bins = []
    for k in range(min_bin + 1, max_bin):
        m = magnitudes[k]
        if m > noise_floor[k] and m >= magnitudes[k - 1] and m >= magnitudes[k + 1]:
            is_peak[k] = True
            peak_bins.append(k)
    if not peak_bins:
        return []

    scores = np.zeros(half, dtype=np.float32)
    frac_bins = np.zeros(half, dtype=np.float32)
    for k in peak_bins:
        fund_mag = magnitudes[k]
        if fund_mag < noise_floor[k] * 5.0:
            scores[k] = 0.0
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            y_l = np.log(magnitudes[k - 1])
            y_c = np.log(magnitudes[k])
            y_r = np.log(magnitudes[k + 1])
            denom = y_l - 2.0 * y_c + y_r
            delta = 0.0 if abs(denom) < 1e-30 else float(
                np.clip(0.5 * (y_l - y_r) / denom, -1.0, 1.0))
        if not np.isfinite(delta):
            # Zero-magnitude neighbor: the reference's NaN candidate is
            # dropped by the final freq filter; drop it here directly.
            scores[k] = 0.0
            continue
        frac_bin = np.float32(k + delta)
        frac_bins[k] = frac_bin
        score = np.float32(fund_mag)
        last = k
        longest_run = current_run = total_harms = 0
        for n in range(2, MAX_HARMONICS + 1):
            expected_f = frac_bin * n
            if expected_f >= half:
                break
            search_start = max(int(np.floor(expected_f - 1.0)) if expected_f >= 1.0 else 0,
                               last + 1)
            search_end = min(int(np.ceil(expected_f + 1.0)), half - 1)
            best_hbin, best_mag = 0, np.float32(0.0)
            for h in range(search_start, search_end + 1):
                if is_peak[h] and magnitudes[h] > best_mag:
                    best_mag = magnitudes[h]
                    best_hbin = h
            if best_hbin != 0:
                score = np.float32(score + best_mag)
                last = best_hbin
                current_run += 1
                total_harms += 1
            else:
                longest_run = max(longest_run, current_run)
                current_run = 0
        longest_run = max(longest_run, current_run)
        if longest_run < 3 and fund_mag < 15.0 * noise_floor[k]:
            scores[k] = 0.0
        else:
            log_score = np.float32(np.log2(np.float32(0.5) + score))
            struct_mult = np.float32(
                (1.0 + longest_run + total_harms / 2.0) / (1.0 + MAX_HARMONICS))
            scores[k] = np.float32(log_score * struct_mult)

    max_score = max((scores[kk] for kk in peak_bins), default=0.0)
    max_score = np.float32(max(max_score, 0.0))
    if max_score == 0.0:
        return []
    cutoff = np.float32(max_score * np.float32(0.5))
    candidates = [(kk, scores[kk]) for kk in peak_bins if scores[kk] >= cutoff]

    def freq_of(b):
        return np.float32(frac_bins[b] * np.float32(bin_width))

    suppressed = []
    for i, (bin_i, score_i) in enumerate(candidates):
        fi = freq_of(bin_i)
        sup = False
        for j, (bin_j, score_j) in enumerate(candidates):
            if i == j:
                continue
            fj = freq_of(bin_j)
            ratio = fi / fj
            nearest = np.round(ratio)
            if (2.0 <= nearest <= 5.0
                    and abs(ratio / nearest - 1.0) < 0.03
                    and score_i < score_j * np.float32(1.05)):
                sup = True
                break
        suppressed.append(sup)
    candidates = [c for c, s in zip(candidates, suppressed) if not s]
    # Stable sort desc by (score, then lower bin — to match top_k tie order).
    candidates.sort(key=lambda c: (-c[1], c[0]))

    deduped = []
    for cand in candidates:
        fi = frac_bins[cand[0]]
        if not any(abs(fi - frac_bins[b]) < 2.0 for b, _ in deduped):
            deduped.append(cand)
    deduped = deduped[:MAX_NOTES]

    out = []
    for b, s in deduped:
        f = freq_of(b)
        if min_freq <= f <= max_freq:
            out.append((float(f), float(s)))
    return out
