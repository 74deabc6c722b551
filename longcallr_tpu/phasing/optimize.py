"""Phasing optimizer: synchronous coordinate ascent + enumeration.

Redesign of ``longcallR/src/phase.rs:810-1395`` (cross_optimize,
phase, cross_optimize_by_block). The reference's per-read/per-SNP argmax
loops are *synchronous* (all reads update from the current SNP state, then
all SNPs from the new read state — tmp maps applied after each half-step),
so each half-step is one batched kernel call; the ≤21-iteration ascent
becomes a ``lax.while_loop`` that is vmappable across the 2^n enumeration
configs (phase.rs:1097-1122) and across regions.

Monotonicity bookkeeping (check_new_haplotag / check_new_haplotype_genotype,
phase.rs:278-355) is computed with the same surrogate sums; the reference
accumulates them in random HashMap order, ours in index order (see SURVEY.md
§4 determinism caveat).

Known deliberate deviation: the reference's cross_optimize_by_block
(phase.rs:1298-1394) accumulates read flips in a HashMap that is never
cleared between blocks and only honours them when the *last* block flips —
behaviour that depends on Rust's randomized HashMap/SCC iteration order and
is nondeterministic run-to-run. We implement the evident intent: each block
that improves flips its own fully-contained reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

from .. import _jaxcfg  # noqa: F401  (x64 before any trace)
import jax
import jax.numpy as jnp
import numpy as np

from ..config import CallerConfig
from ..ops.candidates import CandidateSet
from ..utils.device import phase_problem_device
from .fragments import FragmentMatrix
from .kernels import (TIE_TOL, CellTables, CompactCells, as_tables, f64,
                      make_cell_tables_np, overall_probability, read_logliks,
                      sigma_q, snp_q_for, snp_qs, snp_sums)


class PhaseState(NamedTuple):
    sigma: jnp.ndarray   # [K] f64 in {-1,0,+1}
    delta: jnp.ndarray   # [I] f64 in {-1,+1} (0 = unassigned)
    eta: jnp.ndarray     # [I] f64 in {-1,0,+1}


def _sigma_step(ct: CellTables, st: PhaseState, read_base, site_mask):
    """One σ half-step (phase.rs:823-869). Returns (new_sigma, improved)."""
    lp, lm, ncell = read_logliks(ct, st.delta, st.eta, site_mask[None, :])
    upd = read_base & (st.sigma != 0) & (ncell > 0)
    q, qn = sigma_q(lp, lm, st.sigma)
    # tie-quantized flip (keep current σ at a structural tie) and an exact
    # per-element continue flag — both order-independent (kernels.TIE_TOL)
    flip = upd & (qn > q + TIE_TOL)
    new_sigma = jnp.where(flip, -st.sigma, st.sigma)
    return new_sigma, flip.any()


def _snp_step(ct: CellTables, st: PhaseState, read_base, site_mask,
              conserved, with_genotype: bool, keep_conserved: bool):
    """One (δ, η) half-step (phase.rs:871-965). Returns (delta, eta, improved)."""
    read_mask = read_base & (st.sigma != 0)
    s_match, s_flip, s_refe, s_alte, cov = snp_sums(
        ct, st.sigma, st.delta, read_mask, site_mask)
    q1, q2, q3, q4 = snp_qs(s_match, s_flip, s_refe, s_alte, cov)
    upd = site_mask & (cov > 0)
    if keep_conserved:
        upd &= ~conserved
    if with_genotype:
        mx = jnp.maximum(jnp.maximum(q1, q2), jnp.maximum(q3, q4))
        # tie order q1 > q2 > q3 > q4 (phase.rs:909-921), TIE_TOL-quantized
        pick = jnp.where(q1 >= mx - TIE_TOL, 0,
                         jnp.where(q2 >= mx - TIE_TOL, 1,
                                   jnp.where(q3 >= mx - TIE_TOL, 2, 3)))
    else:
        het = st.eta == 0
        pick = jnp.where(het,
                         jnp.where(q2 > q1 + TIE_TOL, 1, 0),
                         jnp.where(q4 > q3 + TIE_TOL, 3, 2))
    new_delta = jnp.where(upd & (pick == 1), -st.delta, st.delta)
    new_eta = jnp.where(
        upd, jnp.where(pick <= 1, 0.0, jnp.where(pick == 2, 1.0, -1.0)),
        st.eta)
    changed = ((new_delta != st.delta) | (new_eta != st.eta)).any()
    return new_delta, new_eta, changed


def _cross_optimize_loop(ct: CellTables, st: PhaseState, read_base,
                         site_mask, conserved, with_genotype: bool,
                         keep_conserved: bool) -> Tuple[PhaseState, jnp.ndarray]:
    """Traceable core of cross_optimize (inlined by the fused phase loop)."""
    ct = as_tables(ct)

    def cond(carry):
        st, it, go = carry
        return go & (it < 21)

    def body(carry):
        st, it, _ = carry
        new_sigma, s_inc = _sigma_step(ct, st, read_base, site_mask)
        st = st._replace(sigma=new_sigma)
        new_delta, new_eta, d_inc = _snp_step(
            ct, st, read_base, site_mask, conserved, with_genotype,
            keep_conserved)
        st = st._replace(delta=new_delta, eta=new_eta)
        return st, it + 1, s_inc | d_inc

    st, _, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(0), jnp.bool_(True)))
    read_mask = read_base & (st.sigma != 0)
    prob = overall_probability(ct, st.sigma, st.delta, st.eta, read_mask,
                               site_mask[None, :])
    return st, prob


@partial(jax.jit, static_argnames=("with_genotype", "keep_conserved"))
def cross_optimize(ct: CellTables, st: PhaseState, read_base: jnp.ndarray,
                   site_mask: jnp.ndarray, conserved: jnp.ndarray,
                   with_genotype: bool, keep_conserved: bool
                   ) -> Tuple[PhaseState, jnp.ndarray]:
    """Alternating coordinate ascent, ≤21 iterations (phase.rs:810-976).
    Returns (final state, overall log10 probability)."""
    return selected_loop()(ct, st, read_base, site_mask, conserved,
                           with_genotype, keep_conserved)


def _cross_optimize_fast_loop(ct: CellTables, st: PhaseState, read_base,
                              site_mask, conserved, with_genotype: bool,
                              keep_conserved: bool):
    st, prob, _ = _cross_optimize_fast_loop_it(ct, st, read_base, site_mask,
                                               conserved, with_genotype,
                                               keep_conserved)
    return st, prob


def _fast_tables_for(ct, read_base, sigma, site_mask):
    """FastTables(32) for an ascent whose entry state is (σ=sigma): the
    active-read set rm0 = read_base & (σ≠0) is INVARIANT under the ascent
    and the perturbation schedule (σ only ever flips sign, never zeroes),
    so callers that run many ascents over the same region may build the
    tables ONCE and pass them to every call — per-call rebuilds were ~45%
    of the schedule's HBM traffic.

    In f32 mode a CompactCells input takes the FUSED builder (f32 lookups +
    ones-contractions, kernels_fast.fast_tables32_from_compact), which skips
    the expand-to-f64-then-split build's f64 [K,I] passes."""
    from . import kernels_fast as KF
    from .kernels import CompactCells

    rm0 = read_base & (sigma != 0)
    if _f32_mode():
        if isinstance(ct, CompactCells):
            return KF.fast_tables32_from_compact(ct, rm0, site_mask)
        return KF.make_fast_tables32(as_tables(ct), rm0, site_mask)
    return KF.make_fast_tables(as_tables(ct), rm0, site_mask)


def _cross_optimize_fast_loop_it(ct: CellTables, st: PhaseState, read_base,
                                 site_mask, conserved, with_genotype: bool,
                                 keep_conserved: bool, ft=None):
    """Matvec-form ascent (see kernels_fast.py): same argmax/tie rules as the
    reference-form loop, 2 matvecs per iteration instead of ~8 full-matrix
    passes. Opt-in (summation order differs at the ulp level).
    Returns (state, prob, iterations) — the count feeds the bench's
    bytes/flops accounting (perturbation_phase_stats).
    ``ft``: optional prebuilt tables from _fast_tables_for (callers running
    many ascents over one region amortise the build; the active-read mask
    baked into them must equal read_base & (st.sigma != 0))."""
    from . import kernels_fast as KF

    rm0 = read_base & (st.sigma != 0)
    if ft is None:
        ft = _fast_tables_for(ct, read_base, st.sigma, site_mask)
    if _f32_mode():
        # hi/lo f32-split Dp: the matvecs run as f32 contractions
        # (see kernels_fast)
        fast_read_logliks = KF.fast_read_logliks32
        fast_snp_sums = KF.fast_snp_sums32
        fast_overall_probability = KF.fast_overall_probability32
    else:
        fast_read_logliks = KF.fast_read_logliks
        fast_snp_sums = KF.fast_snp_sums
        fast_overall_probability = KF.fast_overall_probability

    def sigma_step(st):
        lp, lm, ncell = fast_read_logliks(ft, st.delta, st.eta)
        upd = rm0 & (ncell > 0)
        q, qn = sigma_q(lp, lm, st.sigma)
        # tie-quantized flip + per-element continue flag (kernels.TIE_TOL)
        flip = upd & (qn > q + TIE_TOL)
        new_sigma = jnp.where(flip, -st.sigma, st.sigma)
        return new_sigma, flip.any()

    def snp_step(st):
        sums = fast_snp_sums(ft, st.sigma, st.delta)
        q1, q2, q3, q4 = snp_qs(*sums)
        cov = sums[4]
        upd = site_mask & (cov > 0)
        if keep_conserved:
            upd &= ~conserved
        if with_genotype:
            mx = jnp.maximum(jnp.maximum(q1, q2), jnp.maximum(q3, q4))
            pick = jnp.where(q1 >= mx - TIE_TOL, 0,
                             jnp.where(q2 >= mx - TIE_TOL, 1,
                                       jnp.where(q3 >= mx - TIE_TOL, 2, 3)))
        else:
            het = st.eta == 0
            pick = jnp.where(het, jnp.where(q2 > q1 + TIE_TOL, 1, 0),
                             jnp.where(q4 > q3 + TIE_TOL, 3, 2))
        new_delta = jnp.where(upd & (pick == 1), -st.delta, st.delta)
        new_eta = jnp.where(
            upd, jnp.where(pick <= 1, 0.0, jnp.where(pick == 2, 1.0, -1.0)),
            st.eta)
        changed = ((new_delta != st.delta) | (new_eta != st.eta)).any()
        return new_delta, new_eta, changed

    def cond(carry):
        st, it, go = carry
        return go & (it < 21)

    def body(carry):
        st, it, _ = carry
        new_sigma, s_inc = sigma_step(st)
        st = st._replace(sigma=new_sigma)
        new_delta, new_eta, d_inc = snp_step(st)
        st = st._replace(delta=new_delta, eta=new_eta)
        return st, it + 1, s_inc | d_inc

    st, it, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(0), jnp.bool_(True)))
    prob = fast_overall_probability(ft, st.sigma, st.delta, st.eta)
    return st, prob, it


@partial(jax.jit, static_argnames=("with_genotype", "keep_conserved"))
def cross_optimize_fast(ct: CellTables, st: PhaseState, read_base,
                        site_mask, conserved, with_genotype: bool,
                        keep_conserved: bool):
    return _cross_optimize_fast_loop(ct, st, read_base, site_mask, conserved,
                                     with_genotype, keep_conserved)


# execution-mode switches (see docs/usage.md). The matvec-form ascent is the
# default everywhere (perturbation schedule, enumeration, batched buckets) —
# full suite + demo byte-identical under it; LONGCALLR_FAST_KERNELS=0
# restores the reference-form loop (the specification path).
USE_FAST_KERNELS = os.environ.get("LONGCALLR_FAST_KERNELS", "1") == "1"
# hi/lo f32-split Dp matvecs (kernels_fast.py): default AUTO by placement,
# from measurement. On the CPU the two-matmul split only adds work. On the
# H100 the split at precision HIGHEST ran the deep workload 12% faster than
# native f64 with byte-identical outputs: f64 moves the same 8 bytes per
# cell, but only the split has the fused bucket program and the device
# block flip (PERF.md, "Bring-up findings (H100)", three-arm A/B).
# LONGCALLR_F32_KERNELS=0/1 forces it; ~1e-4 absolute on the sums, so
# near-tie ascent decisions may differ from the f64 spec (the f64 safety
# net below catches them).
_F32_ENV = os.environ.get("LONGCALLR_F32_KERNELS")
USE_F32_KERNELS: Optional[bool] = (None if _F32_ENV is None
                                   else _F32_ENV == "1")
# platforms on which auto mode takes the split
F32_AUTO_PLATFORMS = frozenset({"gpu"})


def _f32_mode() -> bool:
    """Resolve the tri-state at trace time (the backend is initialised by
    then; resolving at import would trigger device init). Auto keys on the
    platform the program will actually run on: small per-region problems
    are routed to the host CPU backend via jax.default_device (see
    utils/device.py) — jax includes jax_default_device in the jit trace
    context, so the mode re-resolves per placement."""
    if USE_F32_KERNELS is not None:
        return USE_F32_KERNELS
    try:
        dev = jax.config.jax_default_device
        plat = dev.platform if dev is not None else jax.default_backend()
    except RuntimeError:
        return False
    return plat in F32_AUTO_PLATFORMS


def selected_loop():
    return _cross_optimize_fast_loop if USE_FAST_KERNELS else _cross_optimize_loop


# f32 safety net (round-1 review): the hi/lo f32-split sums carry ~1e-4
# absolute error, so a near-tie argmax can deviate from the f64 spec of
# phase.rs:128-176 on exactly the backends where f32 mode defaults on.
# After an f32-mode iterative ascent the final state's decision margins are
# re-evaluated with the exact f64 kernels; when the state is not an f64
# fixed point with margins above this bound, the region is recomputed on
# the host backend (where auto mode resolves to f64).
# LONGCALLR_F32_SAFETY=0 disables; any other value overrides the bound.
_SAFETY_ENV = os.environ.get("LONGCALLR_F32_SAFETY", "")
F32_SAFETY_TOL: float = (float(_SAFETY_ENV) if _SAFETY_ENV else 1e-3)


def _margin_fast_one(p8, q8, sigma, delta, eta, read_base, site_mask):
    """f64_decision_margin via the matvec-form f64 kernels (one pass over
    Dp per gap family instead of ~10 full-matrix masked passes). Sums agree
    with the reference-form kernels to ~1e-12 relative — far inside the
    1e-3 trigger tolerance, so the recompute decision is unchanged except
    exactly at the tolerance boundary, where either answer is safe (the
    margin is a conservative trigger, not a spec quantity)."""
    from . import kernels_fast as KF
    ct = as_tables(CompactCells(p8, q8))
    st = PhaseState(sigma, delta, eta)
    rm0 = read_base & (st.sigma != 0)
    ft = KF.make_fast_tables(ct, rm0, site_mask)
    lp, lm, ncell = KF.fast_read_logliks(ft, st.delta, st.eta)
    upd = rm0 & (ncell > 0)
    q, qn = sigma_q(lp, lm, st.sigma)
    sig_gap = jnp.where(upd, jnp.abs(q - qn), jnp.inf).min()
    sums = KF.fast_snp_sums(ft, st.sigma, st.delta)
    qs = jnp.stack(snp_qs(*sums))                        # [4, I]
    upds = site_mask & (sums[4] > 0)
    mx = qs.max(axis=0)
    am = qs.argmax(axis=0)
    second = jnp.where(jnp.arange(4)[:, None] == am[None, :],
                       -jnp.inf, qs).max(axis=0)
    snp_gap = jnp.where(upds, mx - second, jnp.inf).min()
    return jnp.minimum(sig_gap, snp_gap)


@jax.jit
def f64_decision_margin_fast(p8, q8, sigma, delta, eta, read_base, site_mask):
    return _margin_fast_one(p8, q8, sigma, delta, eta, read_base, site_mask)


@jax.jit
def f64_decision_margin_batched(p8, q8, sigma, delta, eta, read_base,
                                site_mask):
    """Per-region fast margins for a whole bucket in ONE program ([B]
    out) — the batched driver's safety net runs this on the host backend."""
    return jax.vmap(_margin_fast_one)(p8, q8, sigma, delta, eta, read_base,
                                      site_mask)


@jax.jit
def _overall_probability_jit(ct, sigma, delta, eta, read_base, site_mask):
    """cal_overall_probability as one dispatch (accepts CompactCells).
    In f32 mode a CompactCells input evaluates via the fused split tables
    (no f64 expansion/gather on device — see kernels_fast); matches the
    scale of the f32 ascent objectives it is compared against."""
    from .kernels import CompactCells

    if (USE_FAST_KERNELS and _f32_mode()
            and isinstance(ct, CompactCells)):
        from .kernels_fast import fast_overall_probability32
        ft = _fast_tables_for(ct, read_base, sigma, site_mask)
        return fast_overall_probability32(ft, sigma, delta, eta)
    ct = as_tables(ct)
    rm = read_base & (sigma != 0)
    return overall_probability(ct, sigma, delta, eta, rm, site_mask[None, :])


@jax.jit
def f64_decision_margin(ct: CellTables, st: PhaseState, read_base,
                        site_mask) -> jnp.ndarray:
    """Smallest decision gap at the final state, in exact f64: per read the
    |q − q_flip| separation, per SNP the top-2 gap among the four (δ, η)
    candidates of the genotype re-argmax. A gap below the f32 error bound
    means the f32-mode run may have taken a different branch than f64 would
    — the safety net's trigger. (The final state need not be an argmax
    fixed point — the ascent stops on an aggregate rule — so the SIGN of a
    margin is uninformative; only near-tie magnitude is.)"""
    ct = as_tables(ct)
    rm0 = read_base & (st.sigma != 0)
    lp, lm, ncell = read_logliks(ct, st.delta, st.eta, site_mask[None, :])
    upd = rm0 & (ncell > 0)
    q, qn = sigma_q(lp, lm, st.sigma)
    sig_gap = jnp.where(upd, jnp.abs(q - qn), jnp.inf).min()
    sums = snp_sums(ct, st.sigma, st.delta, rm0, site_mask)
    qs = jnp.stack(snp_qs(*sums))                        # [4, I]
    upds = site_mask & (sums[4] > 0)
    mx = qs.max(axis=0)
    am = qs.argmax(axis=0)
    second = jnp.where(jnp.arange(4)[:, None] == am[None, :],
                       -jnp.inf, qs).max(axis=0)
    snp_gap = jnp.where(upds, mx - second, jnp.inf).min()
    return jnp.minimum(sig_gap, snp_gap)


def _predraw_rounds(key, K: int, I: int):
    """Pre-draw every perturbation round's randoms outside the fori body in
    one batched threefry pass (bit-identical to the in-loop
    fold_in(key, t) → split → uniform form). Per-round in-body draws are ~6
    small kernels/round, each with a fixed launch cost; at I//4+1 rounds
    that dwarfed the matvec traffic. The static
    bound R_max = I//4+1 covers every caller (the schedule length is
    n_rounds = I//4+1, phase.rs:1198)."""
    R_max = I // 4 + 1

    def per_round(t):
        kr = jax.random.fold_in(key, t)
        k1, k2 = jax.random.split(kr)
        return (jax.random.uniform(k1, (I,)),
                jax.random.uniform(k2, (K,)))

    return jax.vmap(per_round)(jnp.arange(R_max))   # [R_max,I], [R_max,K]


@jax.jit
def perturbation_phase(ct: CellTables, st: PhaseState, best_st: PhaseState,
                       best_prob, read_base, site_mask, conserved,
                       n_rounds, key) -> Tuple[PhaseState, jnp.ndarray]:
    """The full perturbation schedule (phase.rs:1198-1233) as ONE device
    program: n_rounds iterations of {10%% SNP resets → cross_optimize →
    keep-best → 10%% read flips → cross_optimize → keep-best}, with
    device-side jax.random. Returns (best state, best prob)."""
    K = st.sigma.shape[0]
    I = st.delta.shape[0]
    # the active-read set is schedule-invariant (sigma only flips sign):
    # build the ascent tables ONCE for all 2*n_rounds calls. A CompactCells
    # input in f32 mode goes STRAIGHT to the fused builder (see
    # _fast_tables_for).
    if USE_FAST_KERNELS:
        ft = _fast_tables_for(ct, read_base, st.sigma, site_mask)
        ascend = lambda st0: _cross_optimize_fast_loop_it(
            None, st0, read_base, site_mask, conserved,
            with_genotype=False, keep_conserved=False, ft=ft)[:2]
    else:
        ct = as_tables(ct)
        ascend = lambda st0: _cross_optimize_loop(
            ct, st0, read_base, site_mask, conserved,
            with_genotype=False, keep_conserved=False)

    def keep_best(carry_best, st_new, prob_new):
        b_st, b_p = carry_best
        better = prob_new > b_p + TIE_TOL
        sel = lambda a, b: jnp.where(better, a, b)
        return (PhaseState(sel(st_new.sigma, b_st.sigma),
                           sel(st_new.delta, b_st.delta),
                           sel(st_new.eta, b_st.eta)),
                jnp.where(better, prob_new, b_p))

    rg_all, fl_all = _predraw_rounds(key, K, I)

    def body(tidx, carry):
        (b_st, b_p) = carry
        flip = (tidx % 2) == 1
        lowv = jnp.where(flip, 1.0, -1.0)
        highv = -lowv
        rg = rg_all[tidx]
        delta = jnp.where(rg < 0.1, lowv,
                          jnp.where(rg >= 0.9, highv, b_st.delta))
        st1, prob1 = ascend(b_st._replace(delta=delta))
        b_st, b_p = keep_best((b_st, b_p), st1, prob1)
        fl = (fl_all[tidx] < 0.1) & read_base & (b_st.sigma != 0)
        sigma = jnp.where(fl, -b_st.sigma, b_st.sigma)
        st2, prob2 = ascend(b_st._replace(sigma=sigma))
        b_st, b_p = keep_best((b_st, b_p), st2, prob2)
        return (b_st, b_p)

    best_st, best_prob = jax.lax.fori_loop(
        0, n_rounds, body, (best_st, jnp.asarray(best_prob, f64)))
    return best_st, best_prob


@jax.jit
def perturbation_phase_stats(ct: CellTables, st: PhaseState,
                             best_st: PhaseState, best_prob, read_base,
                             site_mask, conserved, n_rounds, key):
    """perturbation_phase with ascent-iteration accounting: returns
    (best state, best prob, total ascent iterations across all 2·n_rounds
    cross_optimize calls). Each iteration is two passes over the split Dp
    matrix (kernels_fast.py) — the count converts measured wall time into
    bytes-moved / flops for the bench's MFU line. Fast-kernel path only."""
    K = st.sigma.shape[0]
    I = st.delta.shape[0]
    ft = _fast_tables_for(ct, read_base, st.sigma, site_mask)

    def keep_best(carry_best, st_new, prob_new):
        b_st, b_p = carry_best
        better = prob_new > b_p + TIE_TOL
        sel = lambda a, b: jnp.where(better, a, b)
        return (PhaseState(sel(st_new.sigma, b_st.sigma),
                           sel(st_new.delta, b_st.delta),
                           sel(st_new.eta, b_st.eta)),
                jnp.where(better, prob_new, b_p))

    rg_all, fl_all = _predraw_rounds(key, K, I)

    def body(tidx, carry):
        (b_st, b_p, iters) = carry
        flip = (tidx % 2) == 1
        lowv = jnp.where(flip, 1.0, -1.0)
        highv = -lowv
        rg = rg_all[tidx]
        delta = jnp.where(rg < 0.1, lowv,
                          jnp.where(rg >= 0.9, highv, b_st.delta))
        st1, prob1, it1 = _cross_optimize_fast_loop_it(
            None, b_st._replace(delta=delta), read_base, site_mask, conserved,
            with_genotype=False, keep_conserved=False, ft=ft)
        b_st, b_p = keep_best((b_st, b_p), st1, prob1)
        fl = (fl_all[tidx] < 0.1) & read_base & (b_st.sigma != 0)
        sigma = jnp.where(fl, -b_st.sigma, b_st.sigma)
        st2, prob2, it2 = _cross_optimize_fast_loop_it(
            None, b_st._replace(sigma=sigma), read_base, site_mask, conserved,
            with_genotype=False, keep_conserved=False, ft=ft)
        b_st, b_p = keep_best((b_st, b_p), st2, prob2)
        return (b_st, b_p, iters + it1 + it2)

    best_st, best_prob, iters = jax.lax.fori_loop(
        0, n_rounds, body, (best_st, jnp.asarray(best_prob, f64), jnp.int32(0)))
    return best_st, best_prob, iters


# vmapped enumeration: one cross_optimize per initial haplotype config
_enum_vmap = jax.jit(jax.vmap(
    lambda ct, sigma0, delta0, eta0, rb, sm, cons: cross_optimize(
        ct, PhaseState(sigma0, delta0, eta0), rb, sm, cons,
        with_genotype=True, keep_conserved=False),
    in_axes=(None, 0, 0, None, None, None, None)))


def enumeration_order(n: int) -> np.ndarray:
    """All 2^n haplotype configs in the reference's enumeration order
    (phase.rs:1099-1106): start at all-ones; for each snp, append copies of
    every existing config with that snp flipped."""
    configs = [np.ones(n, dtype=np.int8)]
    for ti in range(n):
        for tj in range(len(configs)):
            c = configs[tj].copy()
            c[ti] = -c[ti]
            configs.append(c)
    assert len(configs) == 2 ** n
    return np.stack(configs) if n > 0 else np.ones((1, 0), dtype=np.int8)


# ---------------------------------------------------------------------------
# LD blocks (host): divide_snps_into_blocks (candidate.rs:615-747)
# ---------------------------------------------------------------------------

@dataclass
class LDInfo:
    pair_ld: Dict[Tuple[int, int], Tuple[float, int]]  # (score f32, weight)
    blocks: List[List[int]]          # each ≥1 snp, sorted; list sorted by min
    block_id: np.ndarray             # [I] int32, -1 if unblocked
    adj: Dict[int, List[int]]        # ld_graph adjacency (post weight filter)


def compute_ld_blocks(cands: CandidateSet, frags: FragmentMatrix,
                      ld_weight_threshold: int = 1) -> LDInfo:
    pair_ld: Dict[Tuple[int, int], Tuple[float, int]] = {}
    edges: Dict[Tuple[int, int], int] = {}
    nodes: Set[int] = set()
    ref_ok = ((cands.alleles[:, 0] == cands.ref_base)
              | (cands.alleles[:, 1] == cands.ref_base))
    # allele_freqs of (ref, alt) nonzero requirement (candidate.rs:670-676)
    ref_is_a1 = cands.alleles[:, 0] == cands.ref_base
    ref_frac = np.where(ref_is_a1, cands.allele_freqs[:, 0], cands.allele_freqs[:, 1])
    alt_frac = np.where(ref_is_a1, cands.allele_freqs[:, 1], cands.allele_freqs[:, 0])
    for (i, j), tbl in frags.ld_counts.items():
        if not (cands.for_phasing[i] and cands.for_phasing[j]):
            continue
        if not (ref_ok[i] and ref_ok[j]):
            continue
        if ref_frac[i] == 0 or alt_frac[i] == 0 or ref_frac[j] == 0 or alt_frac[j] == 0:
            continue
        c_rr, c_ra, c_ar, c_aa = int(tbl[0, 0]), int(tbl[0, 1]), int(tbl[1, 0]), int(tbl[1, 1])
        same = c_rr + c_aa
        opp = c_ra + c_ar
        c1, c2 = min(same, opp), max(same, opp)
        score = np.float32(c1) / np.float32(c2)  # NaN when c2 == 0
        if same > opp:
            sw = (float(score), c2)
        else:
            sw = (float(-score), -c2)
        pair_ld[(i, j)] = sw
        if score == 0.0:  # perfect LD (c1==0, c2>0); NaN fails
            edges[(i, j)] = sw[1]
            nodes.add(i)
            nodes.add(j)
    # weight filter (|w| < threshold dropped), nodes retained
    adj: Dict[int, List[int]] = {n: [] for n in nodes}
    for (i, j), w in edges.items():
        if abs(w) >= ld_weight_threshold:
            adj[i].append(j)
            adj[j].append(i)
    # connected components (deterministic: ordered by min node)
    block_id = np.full(cands.n, -1, dtype=np.int32)
    blocks: List[List[int]] = []
    seen: Set[int] = set()
    for start in sorted(nodes):
        if start in seen:
            continue
        comp = []
        stack = [start]
        seen.add(start)
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        comp.sort()
        blocks.append(comp)
    for bid, comp in enumerate(blocks):
        for u in comp:
            block_id[u] = bid
    for n in adj:
        adj[n].sort()
    return LDInfo(pair_ld=pair_ld, blocks=blocks, block_id=block_id, adj=adj)


def init_haplotypes_ld(cands: CandidateSet, ld: LDInfo,
                       rng: np.random.Generator,
                       ld_weight_threshold: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """init_haplotypes_LD2 (phase.rs:609-671): random ±1 everywhere, then
    BFS-consistent haplotypes inside each perfect-LD block. Returns
    (delta0[I] int8, conserved[I] bool)."""
    n = cands.n
    delta = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int8)
    conserved = np.zeros(n, dtype=bool)
    for comp in ld.blocks:
        if len(comp) < 2:
            continue
        root = comp[0]
        delta[root] = 1
        visited = [root]
        vset = {root}
        queue = [root]
        order = []
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in ld.adj.get(u, []):
                if v not in vset:
                    vset.add(v)
                    queue.append(v)
        for nx in order:
            if nx == root:
                continue
            for vi in visited:
                a, b = (vi, nx) if vi < nx else (nx, vi)
                sw = ld.pair_ld.get((a, b))
                if sw is None or sw[0] != 0.0:
                    continue
                w = sw[1]
                if w >= ld_weight_threshold:
                    delta[nx] = delta[vi]
                    break
                if w <= -ld_weight_threshold:
                    delta[nx] = -delta[vi]
                    break
            visited.append(nx)
        for u in comp:
            conserved[u] = True
    return delta, conserved


# ---------------------------------------------------------------------------
# Block flip pass: cross_optimize_by_block (phase.rs:1298-1394)
# ---------------------------------------------------------------------------

@jax.jit
def _block_flip_fast_jit(p8, q8, sigma, delta, eta, read_base, site_mask,
                         bid):
    """Single-region device block flip over the split tables (f32 mode only
    — see kernels_fast.fast_block_flip32 and mesh.batched_block_flip)."""
    from . import kernels_fast as KF
    ft = _fast_tables_for(CompactCells(p8, q8), read_base, sigma, site_mask)
    return KF.fast_block_flip32(ft, p8, sigma, delta, eta, site_mask, bid)


def block_flip_pass(ct_np: CellTables, st: PhaseState, read_base: np.ndarray,
                    site_mask: np.ndarray, exists: np.ndarray,
                    ld: LDInfo) -> PhaseState:
    """For every LD block: flip the whole block (and reads fully contained in
    it) if that raises the block objective. All decisions are computed
    against the current state, then applied together."""
    ct = ct_np
    if not ld.blocks:
        return st
    sigma = np.asarray(st.sigma)
    delta = np.asarray(st.delta)
    eta = np.asarray(st.eta)
    K, I = exists.shape
    n_elems = exists.sum(axis=1)
    read_mask = read_base & (sigma != 0)
    # per-snp masked sums with current sigma (host numpy: this pass runs
    # once per region, off the jitted hot loop)
    pj = np.asarray(ct.p)
    l1m = np.asarray(ct.l1m)
    lerr = np.asarray(ct.lerr)
    m0 = site_mask[None, :] & exists & read_mask[:, None]
    x0 = sigma[:, None] * delta[None, :]
    s_match = np.where(m0, np.where(pj == x0, l1m, lerr), 0.0).sum(axis=0)
    s_flip = np.where(m0, np.where(pj == -x0, l1m, lerr), 0.0).sum(axis=0)
    s_refe = np.where(m0, np.where(pj == 1.0, l1m, lerr), 0.0).sum(axis=0)
    s_alte = np.where(m0, np.where(pj == -1.0, l1m, lerr), 0.0).sum(axis=0)
    cov = m0.sum(axis=0)
    # flip variant: sigma' = -sigma for reads fully inside the snp's block
    block_id = ld.block_id
    if block_id.shape[0] < I:
        block_id = np.pad(block_id, (0, I - block_id.shape[0]),
                          constant_values=-1)
    full_in = np.zeros((K,), dtype=np.int32) - 1  # block fully containing read
    for bid, comp in enumerate(ld.blocks):
        cols = np.asarray(comp)
        n_in = exists[:, cols].sum(axis=1)
        full = (n_in == n_elems) & (n_elems > 0)
        full_in[full] = bid
    flip_factor = np.ones((K, I), dtype=np.int8)
    blocked_cols = block_id >= 0
    ff_rows = full_in[:, None] == block_id[None, :]
    flip_factor[ff_rows & blocked_cols[None, :]] = -1
    # S'_match-flip: x = sigma*flip_factor*(-delta) per cell
    m = m0
    x_new = sigma[:, None] * flip_factor * (-delta[None, :])
    s_match_new = np.where(m, np.where(pj == x_new, l1m, lerr), 0.0).sum(axis=0)
    s_flip_new = np.where(m, np.where(pj == -x_new, l1m, lerr), 0.0).sum(axis=0)
    # genotype-prior constants: THE copies live in kernels.py (phase.rs:
    # 136-144) — import, never re-derive (same rule as kernels_fast)
    from .kernels import (PRIOR_HOMREF_LOG, PRIOR_HOMVAR_LOG, _LOG10_HALF,
                          _PRIOR_HET_BASE)
    ph = np.where(cov == 0, _PRIOR_HET_BASE,
                  _PRIOR_HET_BASE - cov * _LOG10_HALF)
    p_homref = PRIOR_HOMREF_LOG
    p_homvar = PRIOR_HOMVAR_LOG

    def q_of(sm, sf, e):
        n1 = np.where(e == 0, sm + ph, np.where(e == 1, s_refe + p_homref,
                                                s_alte + p_homvar))
        d = (s_alte + p_homvar) + (sm + ph) + (s_refe + p_homref) + (sf + ph)
        return 1.0 - n1 / d

    q_cur = q_of(s_match, s_flip, eta)
    q_new = q_of(s_match_new, s_flip_new, eta)
    new_delta = delta.copy()
    new_sigma = sigma.copy()
    phase_site_cells = exists & site_mask[None, :]
    for bid, comp in enumerate(ld.blocks):
        cols = np.asarray(comp)
        if q_new[cols].sum() > q_cur[cols].sum() + TIE_TOL:
            new_delta[cols] = -delta[cols]
            covers = phase_site_cells[:, cols].any(axis=1)
            flip_reads = (full_in == bid) & covers & read_mask
            new_sigma[flip_reads] = -sigma[flip_reads]
    # numpy out: this is a host pass — placing the (small) vectors on the
    # default device here would bounce them through the accelerator between
    # two host stages
    return PhaseState(new_sigma.astype(np.float64),
                      new_delta.astype(np.float64), np.asarray(st.eta))


# ---------------------------------------------------------------------------
# phase(): top-level per-region optimization (phase.rs:1087-1296)
# ---------------------------------------------------------------------------

def init_genotype(cands: CandidateSet) -> np.ndarray:
    """variant_type → eta (phase.rs:682-691)."""
    vt = cands.variant_type
    return np.where(vt == 0, 1, np.where(vt == 1, 0, -1)).astype(np.int8)


def _bucket(n: int, lo: int = 8) -> int:
    """Round up to a power of two (compile-count control: jitted shapes are
    bucketed so regions share compiled executables)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def phase_region(frags: FragmentMatrix, cands: CandidateSet,
                 cfg: CallerConfig, seed: int,
                 apply_downsampling: bool = False) -> PhaseState:
    """Run the full phase() optimization for one region. Returns the final
    state (sliced back to true sizes); haplotag/haplotype/genotype are
    written back by the caller. Inputs are padded to power-of-two buckets
    (padding rows/cols are fully masked)."""
    K0, I0 = frags.p.shape
    if I0 == 0:
        return PhaseState(np.zeros(K0), np.zeros(0), np.zeros(0))
    st = _phase_region_padded(frags, cands, cfg, seed, apply_downsampling)
    # numpy out (single readback): every consumer is a host stage
    return PhaseState(np.asarray(st.sigma)[:K0], np.asarray(st.delta)[:I0],
                      np.asarray(st.eta)[:I0])


def _phase_region_padded(frags: FragmentMatrix, cands: CandidateSet,
                         cfg: CallerConfig, seed: int,
                         apply_downsampling: bool) -> PhaseState:
    K0, I0 = frags.p.shape
    K, I_pad = _bucket(max(1, K0)), _bucket(max(1, I0))
    # route giant iterative regions to the reads-sharded ascent (the
    # sequence-parallel analog; parallel/giant.py) when a multi-device mesh
    # exists — the reference serialises such loci on one rayon worker
    if I0 > cfg.max_enum_snps:
        from ..parallel.giant import GIANT_CELLS, phase_region_sharded, reads_mesh
        if K * I_pad >= GIANT_CELLS:
            mesh = reads_mesh()
            if mesh is not None:
                from ..pipeline.engine import stage_add
                stage_add("phase_giant_sharded", 1)
                return phase_region_sharded(frags, cands, cfg, seed,
                                            apply_downsampling, mesh)
    # route low-work regions to the host CPU backend (work = cells × rounds
    # — the schedule's cost model, see utils/device.py)
    if I0 <= cfg.max_enum_snps:
        work = (1 << min(I0, 40)) * K * I_pad
    else:
        work = K * I_pad * (I0 // 4 + 1)
    dev = phase_problem_device(work)
    if dev is not None:
        with jax.default_device(dev):
            return _phase_region_padded_impl(frags, cands, cfg, seed,
                                             apply_downsampling, K0, I0, K, I_pad)
    return _phase_region_padded_impl(frags, cands, cfg, seed,
                                     apply_downsampling, K0, I0, K, I_pad)


def _phase_region_padded_impl(frags, cands, cfg, seed, apply_downsampling,
                              K0, I0, K, I_pad) -> PhaseState:
    I = I0  # logical candidate count (enumeration path keys off this)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, seed & 0x7FFFFFFF]))
    padKI = lambda a: np.pad(a, ((0, K - K0), (0, I_pad - I0)))
    padK = lambda a, v=0: np.pad(a, (0, K - K0), constant_values=v)
    padI = lambda a, v=0: np.pad(a, (0, I_pad - I0), constant_values=v)
    # compact transfer form: 2 bytes/cell to the device; the f64 emission
    # tables expand inside the jitted programs (kernels.expand_cells —
    # bit-identical to host expansion). Host f64 tables are built lazily
    # only where a host pass needs them (block flip).
    p_pad = padKI(frags.p)
    q_pad = padKI(frags.baseq).astype(np.uint8)
    from ..utils.device import accel_placement
    if accel_placement():
        # accelerator target: 1-byte/cell joint transfer, bit-exact device
        # unpack (kernels.pack_cells_np)
        from .kernels import pack_cells_np, unpack_cells
        ct = CompactCells(*unpack_cells(
            jnp.asarray(pack_cells_np(p_pad, q_pad))))
    else:
        ct = CompactCells(jnp.asarray(p_pad), jnp.asarray(q_pad))
    site_mask_np = padI(cands.for_phasing)
    site_mask = jnp.asarray(site_mask_np)
    ds = frags.downsampled if apply_downsampling else np.ones(K0, bool)
    read_base_np = padK(frags.for_phasing & ds)
    read_base = jnp.asarray(read_base_np)
    eta0 = padI(init_genotype(cands), 1)

    ld = compute_ld_blocks(cands, frags)

    if I <= cfg.max_enum_snps:
        # enumeration path (phase.rs:1097-1122)
        configs = enumeration_order(I).astype(np.float64)          # [C,I0]
        configs = np.pad(configs, ((0, 0), (0, I_pad - I)), constant_values=1.0)
        C = configs.shape[0]
        sig0 = np.where(rng.random((C, K)) < 0.5, -1.0, 1.0)
        sig0 = np.where(read_base_np[None, :], sig0, 0.0)
        cons = jnp.zeros(I_pad, dtype=bool)
        # chunk configs to bound peak memory (C·K·I f64 intermediates);
        # power-of-two chunk divides C=2^n evenly → one compiled shape
        chunk = max(1, int(2 ** 24 // max(1, K * I_pad)))
        chunk = min(C, 1 << (chunk.bit_length() - 1))
        best_prob = -np.inf
        best_st = None
        best_idx = -1
        all_probs: List[np.ndarray] = []
        for c0 in range(0, C, chunk):
            sts, probs = _enum_vmap(
                ct, jnp.asarray(sig0[c0:c0 + chunk]),
                jnp.asarray(configs[c0:c0 + chunk]),
                jnp.asarray(eta0.astype(np.float64)), read_base, site_mask, cons)
            probs = np.asarray(probs)
            all_probs.append(probs)
            # sequential keep-best with the tie-quantized rule: a config
            # replaces the incumbent only when its prob exceeds it by
            # TIE_TOL — first-in-enumeration-order wins structural ties
            # independent of summation order (kernels.TIE_TOL). The scan is
            # numpy; the device result tree is sliced once per chunk.
            sel = -1
            for j in range(len(probs)):
                if probs[j] > best_prob + TIE_TOL:
                    best_prob = float(probs[j])
                    sel = j
            if sel >= 0:
                best_idx = c0 + sel
                best_st = jax.tree_util.tree_map(lambda a: a[sel], sts)
        if USE_FAST_KERNELS and _f32_mode() and F32_SAFETY_TOL > 0:
            # f32 safety net, enumeration leg (round-2 advisor): both the
            # per-config ascents AND the cross-config best-prob comparison
            # ran in f32 on the accelerator. Recompute on the host backend
            # (auto → f64 there) when the winning state's f64 decision
            # margins are inside the f32 error bound, or when another
            # OTHER config's prob is within the bound of the winner's —
            # above it included: the sequential TIE_TOL keep-best can leave
            # a later config up to TIE_TOL above the winner, whose gap then
            # reads negative here and forces the rerun. Only the winner's
            # own entry is excluded (equal final states and global-flip
            # twins produce bit-equal probs in every precision and resolve
            # identically by the first-in-enumeration-order rule).
            pv = np.concatenate(all_probs)
            others = np.delete(pv, best_idx)
            cfg_gap = (best_prob - float(others.max())
                       if others.size else np.inf)
            cpu = jax.devices("cpu")[0]
            with jax.default_device(cpu):
                if _f32_mode():   # forced-f32 env: no exact rerun exists
                    return best_st
                st_h = PhaseState(*(jnp.asarray(np.asarray(a))
                                    for a in best_st))
                margin = float(f64_decision_margin_fast(
                    jnp.asarray(p_pad), jnp.asarray(q_pad), st_h.sigma,
                    st_h.delta, st_h.eta, jnp.asarray(read_base_np),
                    jnp.asarray(site_mask_np)))
                if min(margin, cfg_gap) < F32_SAFETY_TOL:
                    return _phase_region_padded_impl(
                        frags, cands, cfg, seed, apply_downsampling,
                        K0, I0, K, I_pad)
        return best_st

    # iterative path (phase.rs:1123-1294)
    delta0, conserved_np = init_haplotypes_ld(cands, ld, rng)
    delta0 = np.pad(delta0, (0, I_pad - I), constant_values=1)
    conserved_np = np.pad(conserved_np, (0, I_pad - I))
    conserved = jnp.asarray(conserved_np)
    sigma0 = np.where(rng.random(K) < 0.5, -1.0, 1.0)
    sigma0 = np.where(read_base_np, sigma0, 0.0)
    st = PhaseState(jnp.asarray(sigma0, f64), jnp.asarray(delta0, f64),
                    jnp.asarray(eta0, f64))

    best_prob = -np.inf
    best_st = st

    def consider(st, prob):
        nonlocal best_prob, best_st
        p = float(prob)
        if p > best_prob + TIE_TOL:   # tie-quantized keep-best
            best_prob = p
            best_st = st

    st, prob = cross_optimize(ct, st, read_base, site_mask, conserved,
                              with_genotype=False, keep_conserved=True)
    consider(st, prob)
    st = best_st

    # block flip: in f32 mode the pass runs on the device over the split
    # tables (no host f64 [K,I] tables — at giant-region scale those cost
    # seconds of first-touch page faults); a region whose smallest
    # per-block decision margin is inside the f32 envelope is recomputed
    # with the exact host pass, so decisions match the f64 path (same
    # contract as the batched driver, kernels_fast.fast_block_flip32)
    st2 = None
    if USE_FAST_KERNELS and _f32_mode():
        from . import kernels_fast as KF
        bid_pad = np.full(I_pad, -1, np.int32)
        bid_pad[:ld.block_id.shape[0]] = ld.block_id
        sg2, dl2, mg = _block_flip_fast_jit(
            ct.p, ct.q, st.sigma, st.delta, st.eta, read_base, site_mask,
            jnp.asarray(bid_pad))
        if float(mg) >= KF.F32_BF_TOL:
            st2 = PhaseState(sg2, dl2, st.eta)
    if st2 is None:
        exists_pad = np.zeros((K, I_pad), dtype=bool)
        exists_pad[:K0, :I] = frags.exists()
        ct_np = make_cell_tables_np(p_pad, q_pad)  # host pass: block flip only
        st2 = block_flip_pass(ct_np, st, read_base_np, site_mask_np,
                              exists_pad, ld)
        del ct_np
    prob = _overall_probability_jit(ct, st2.sigma, st2.delta, st2.eta,
                                    read_base, site_mask)
    consider(st2, prob)
    st = best_st

    # perturbation rounds (phase.rs:1198-1233) — fused into ONE device call
    # (I//4+1 rounds of two perturb+ascend passes, device-side jax.random)
    n_rounds = I // 4 + 1
    key = jax.random.PRNGKey(
        int(rng.integers(0, np.iinfo(np.int64).max, dtype=np.int64)))
    best_st, best_prob_dev = perturbation_phase(
        ct, best_st, best_st, jnp.asarray(best_prob, f64), read_base,
        site_mask, conserved, jnp.int32(n_rounds), key)
    if USE_FAST_KERNELS and _f32_mode() and F32_SAFETY_TOL > 0:
        # f32 safety net: accept the f32-mode result only when it is an f64
        # fixed point with all winning margins above the bound; otherwise
        # recompute the region on the host backend (auto → f64 there). The
        # margin itself is evaluated on the host CPU (native f64, and the
        # same placement the batched driver's net uses).
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            if _f32_mode():       # forced-f32 env: no exact rerun exists
                return best_st
            st_h = PhaseState(*(jnp.asarray(np.asarray(a)) for a in best_st))
            margin = float(f64_decision_margin_fast(
                jnp.asarray(p_pad), jnp.asarray(q_pad), st_h.sigma,
                st_h.delta, st_h.eta, jnp.asarray(read_base_np),
                jnp.asarray(site_mask_np)))
            if margin < F32_SAFETY_TOL:
                return _phase_region_padded_impl(
                    frags, cands, cfg, seed, apply_downsampling,
                    K0, I0, K, I_pad)
    return best_st
