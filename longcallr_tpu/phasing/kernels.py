"""Phasing probability kernels: batched masked reductions over [K,I] cells.

Reformulation of the reference's scalar probability functions
(``longcallR/src/phase.rs:14-255``): ``aki`` emissions, the read-level
surrogate ``cal_sigma_delta_eta_log`` (phase.rs:77-96), the SNP-level
``cal_delta_eta_sigma_log`` with genotype priors (phase.rs:128-176), the
phase score (phase.rs:238-255) and the overall objective (phase.rs:257-276).

Every quantity is a sum of per-cell log-emission terms over a reads×SNPs
incidence mask, evaluated for all reads (or all SNPs) of a region at once:
one fused elementwise+reduce program per half-step instead of the
reference's per-read/per-SNP Vec gathers. The surrogate ratios
``1 - logQ1/(ΣlogQs)`` are computed with the exact same f64 expressions as
the reference so that argmax decisions and monotonicity bookkeeping agree.

All math stays in log domain (no exponentiation anywhere in the reference's
formulas either).
"""

from __future__ import annotations

import math
import os as _os
from typing import NamedTuple, Tuple

from .. import _jaxcfg  # noqa: F401  (x64 before any trace)
import jax
import jax.numpy as jnp
import numpy as _np

from ..config import MAX_BASE_QUALITY

f64 = jnp.float64

# log10 emission tables indexed by capped baseq: error term and 1-error term
# (prob = 10^(-q/10), fragment.rs:133)
# numpy (NOT jnp): module-level device arrays would initialize the JAX
# backend at import — a device start-up every CLI invocation would pay,
# even pure-host paths like --get-blocks
_QS = _np.arange(MAX_BASE_QUALITY + 1, dtype=_np.float64)
LOG10_ERR_T = -_QS / 10.0  # log10(10^(-q/10)) == -q/10 exactly
with _np.errstate(divide="ignore"):
    LOG10_1MERR_T = _np.log10(-_np.expm1(-_QS / 10.0 * math.log(10.0)))
# q = 0: err = 1 → log10(1-err) = -inf, as in the reference

# genotype priors (phase.rs:136-144)
PRIOR_HOMREF_LOG = math.log10(1.0 - 1.5 * 0.001)
PRIOR_HOMVAR_LOG = math.log10(0.5 * 0.001)
_LOG10_HALF = math.log10(2.0)
_PRIOR_HET_BASE = math.log10(0.001)


class CellTables(NamedTuple):
    """Fixed per-region cell data (device jnp arrays or host numpy; the
    assignment layer uses the numpy variant to stay off the device)."""

    p: jnp.ndarray        # [K,I] f64 in {-1,0,+1}
    lerr: jnp.ndarray     # [K,I] f64 log10(err), 0 where no cell
    l1m: jnp.ndarray      # [K,I] f64 log10(1-err), 0 where no cell
    exists: jnp.ndarray   # [K,I] bool


_LOG10_ERR_NP = LOG10_ERR_T
_LOG10_1MERR_NP = LOG10_1MERR_T


def make_cell_tables_np(p_np, baseq_np) -> CellTables:
    """Host (numpy) cell tables — used by the assignment/rescue layer so no
    device round trips happen off the hot phasing path."""
    p = _np.asarray(p_np, dtype=_np.float64)
    q = _np.asarray(baseq_np, dtype=_np.int32)
    exists = p != 0
    lerr = _np.where(exists, _LOG10_ERR_NP[q], 0.0)
    l1m = _np.where(exists, _LOG10_1MERR_NP[q], 0.0)
    return CellTables(p=p, lerr=lerr, l1m=l1m, exists=exists)


def make_cell_tables(p_np, baseq_np) -> CellTables:
    ct = make_cell_tables_np(p_np, baseq_np)
    return CellTables(p=jnp.asarray(ct.p), lerr=jnp.asarray(ct.lerr),
                      l1m=jnp.asarray(ct.l1m), exists=jnp.asarray(ct.exists))


class CompactCells(NamedTuple):
    """Device-transfer form of the per-region cell data: 2 bytes/cell
    instead of the 25 bytes/cell of expanded CellTables. The f64 emission
    tables are expanded ON DEVICE (expand_cells) inside the jitted programs
    — an exact gather from the same log10 tables, so results are
    bit-identical to host expansion while host→HBM traffic drops ~12× and
    the host never materialises padded f64 tables (this VM pays ~0.5 ms per
    first-touch page; a [B,K,I] f64 table build recurrently cost 14-45 s
    per wave at deep-workload scale)."""

    p: jnp.ndarray   # [K,I] int8 in {-1,0,+1} (0 = no cell)
    q: jnp.ndarray   # [K,I] uint8 capped baseq


def pack_cells_np(p_np, q_np) -> _np.ndarray:
    """Joint 1-byte/cell encoding of (p, q) for host→device transfer: half
    the 2-byte CompactCells bytes are (p, q) redundancy (p = 0 means q is
    unused). c = 0 for no cell, else 1 + 2·q + [p > 0]; exact for
    q ≤ 126 (BAM quals are ≤ 93 and everything downstream clamps at
    MAX_BASE_QUALITY anyway). unpack_cells inverts it bit-exactly on
    device."""
    p = _np.asarray(p_np)
    q = _np.minimum(_np.asarray(q_np, dtype=_np.int32), 126)
    return _np.where(p == 0, 0,
                     1 + 2 * q + (p > 0)).astype(_np.uint8)


@jax.jit
def unpack_cells(c) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Device inverse of pack_cells_np → (p int8, q uint8). One tiny
    elementwise program per bucket; every downstream batched program then
    consumes the HBM-resident (p, q) unchanged (no retraces)."""
    exists = c != 0
    p = jnp.where(exists,
                  jnp.where((c & 1) == 0, jnp.int8(1), jnp.int8(-1)),
                  jnp.int8(0)).astype(jnp.int8)
    q = jnp.where(exists, (c - 1) >> 1, 0).astype(jnp.uint8)
    return p, q


def expand_cells(cc: CompactCells) -> CellTables:
    """Traceable CompactCells → CellTables (see make_cell_tables_np)."""
    exists = cc.p != 0
    # explicit clamp: device gathers clip out-of-bounds indices silently;
    # baseq is capped at MAX_BASE_QUALITY upstream (fragment.rs:127-131)
    qi = jnp.minimum(cc.q.astype(jnp.int32), MAX_BASE_QUALITY)
    lerr = jnp.where(exists, jnp.asarray(_LOG10_ERR_NP)[qi], 0.0)
    l1m = jnp.where(exists, jnp.asarray(_LOG10_1MERR_NP)[qi], 0.0)
    return CellTables(p=cc.p.astype(f64), lerr=lerr, l1m=l1m, exists=exists)


def as_tables(ct) -> CellTables:
    """Accept either expanded CellTables or CompactCells (expanded here, at
    the top of the jitted program, so downstream reuse is HBM-resident and
    loop-invariant expansion hoists out of ascent loops)."""
    return expand_cells(ct) if isinstance(ct, CompactCells) else ct


def _cell_term(ct: CellTables, x: jnp.ndarray) -> jnp.ndarray:
    """log10 aki per cell for target allele x[k,i] ∈ {-1,+1} (phase.rs:32-49):
    (p == x) ? log10(1-err) : log10(err)."""
    return jnp.where(ct.p == x, ct.l1m, ct.lerr)


def read_logliks(ct: CellTables, delta: jnp.ndarray, eta: jnp.ndarray,
                 site_mask: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-read log-sums L(σ=+1), L(σ=-1) over masked cells, plus per-read
    cell counts. x = σ·δ_i where η_i==0 else η_i (phase.rs:32-49)."""
    m = site_mask & ct.exists
    x_plus = jnp.where(eta == 0, delta, eta)[None, :]
    x_minus = jnp.where(eta == 0, -delta, eta)[None, :]
    tp = jnp.where(m, _cell_term(ct, x_plus), 0.0)
    tm = jnp.where(m, _cell_term(ct, x_minus), 0.0)
    return tp.sum(axis=1), tm.sum(axis=1), m.sum(axis=1)


# Decision tie tolerance (LONGCALLR_TIE_TOL; 0 restores strict float
# comparisons). The ascent/keep-best decisions compare f64 sums whose
# summation ORDER differs between the scalar reference form, eager numpy,
# and XLA-fused programs — at STRUCTURAL ties (states whose exact-arithmetic
# objectives are equal, e.g. a read with perfectly balanced evidence, where
# q and qn sum the same multiset of terms in different orders) the strict
# comparison resolves by accumulated rounding (~1e-16..1e-13), making the
# chosen optimum an artifact of kernel fusion. Quantizing every decision at
# TIE_TOL makes them order-independent: exact ties resolve by the
# reference's documented tie rules (keep current σ; q1>q2>q3>q4 priority;
# first-in-order keep-best), and genuine gaps — ≥ ~1e-4 for the q
# surrogates by the quantization of the log10 terms — are untouched. The
# reference's own behavior at structural ties is rounding-order-dependent
# (and its unseeded thread_rng makes those regions nondeterministic anyway,
# SURVEY.md §4); see PARITY.md deviation #8.
TIE_TOL = float(_os.environ.get("LONGCALLR_TIE_TOL", "1e-9"))


def sigma_q(lp: jnp.ndarray, lm: jnp.ndarray, sigma: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(q, qn) per read: the surrogate 1 - logQ1/(logQ2+logQ3)
    (phase.rs:77-96) for current σ and flipped σ."""
    d = lp + lm
    l_cur = jnp.where(sigma > 0, lp, lm)
    l_flip = jnp.where(sigma > 0, lm, lp)
    return 1.0 - l_cur / d, 1.0 - l_flip / d


def snp_sums(ct: CellTables, sigma: jnp.ndarray, delta: jnp.ndarray,
             read_mask: jnp.ndarray, site_mask: jnp.ndarray):
    """Per-SNP masked sums feeding cal_delta_eta_sigma_log (phase.rs:128-176).

    Returns (S_match, S_flip, S_refe, S_alte, cov):
      S_match = Σ_k log aki(σ_k, δ_i, 0)   — x = σ·δ
      S_flip  = Σ_k log aki(σ_k, -δ_i, 0)
      S_refe  = Σ_k log aki(·, ·, +1)      — x = +1
      S_alte  = Σ_k log aki(·, ·, -1)      — x = -1
      cov     = number of gathered cells (sigma.len())
    """
    m = site_mask[None, :] & ct.exists & read_mask[:, None]
    x_match = (sigma[:, None] * delta[None, :])
    s_match = jnp.where(m, _cell_term(ct, x_match), 0.0).sum(axis=0)
    s_flip = jnp.where(m, _cell_term(ct, -x_match), 0.0).sum(axis=0)
    s_refe = jnp.where(m, _cell_term(ct, 1.0), 0.0).sum(axis=0)
    s_alte = jnp.where(m, _cell_term(ct, -1.0), 0.0).sum(axis=0)
    cov = m.sum(axis=0)
    return s_match, s_flip, s_refe, s_alte, cov


def prior_het_log(cov: jnp.ndarray) -> jnp.ndarray:
    """Het-var prior log10(0.001) - cov·log10(2) (phase.rs:139-144)."""
    return jnp.where(cov == 0, _PRIOR_HET_BASE,
                     _PRIOR_HET_BASE - cov.astype(f64) * _LOG10_HALF)


def snp_qs(s_match, s_flip, s_refe, s_alte, cov):
    """(q1, q2, q3, q4) per SNP — cal_delta_eta_sigma_log for the four
    candidate (δ, η) states evaluated in cross_optimize (phase.rs:904-907):
      q1: (δ, 0)   q2: (-δ, 0)   q3: (δ, +1)   q4: (δ, -1).
    All four share the same denominator (the η=0 terms are symmetric in δ
    and the η=±1 terms are δ-independent)."""
    ph = prior_het_log(cov)
    n1 = s_match + ph
    n2 = s_flip + ph
    n3 = s_refe + PRIOR_HOMREF_LOG
    n4 = s_alte + PRIOR_HOMVAR_LOG
    d = n4 + n1 + n3 + n2  # logq2+logq3+logq4+logq5 with priors (phase.rs:159-169)
    return 1.0 - n1 / d, 1.0 - n2 / d, 1.0 - n3 / d, 1.0 - n4 / d


def snp_q_for(s_match, s_flip, s_refe, s_alte, cov, eta):
    """cal_delta_eta_sigma_log for the CURRENT (δ, η) of each SNP — used by
    the monotonicity bookkeeping (check_new_haplotype_genotype)."""
    q1, q2, q3, q4 = snp_qs(s_match, s_flip, s_refe, s_alte, cov)
    return jnp.where(eta == 0, q1, jnp.where(eta == 1, q3, q4))


def phase_score_q(ct: CellTables, sigma: jnp.ndarray, delta_i,
                  read_mask: jnp.ndarray, col_mask: jnp.ndarray) -> jnp.ndarray:
    """cal_phase_score_log for one SNP column (phase.rs:238-255): scalar
    1 - L(δ)/(L(+1)+L(-1)) with η=0, over the masked cells of that column.

    ``col_mask``[k,i] selects exactly the gathered cells; delta_i ∈ {±1}.
    Returns the surrogate q (phase score is -10·log10(1-q) at the caller).
    """
    m = col_mask & ct.exists & read_mask[:, None]
    x_plus = sigma[:, None] * 1.0
    lp = jnp.where(m, _cell_term(ct, x_plus), 0.0).sum()
    lm = jnp.where(m, _cell_term(ct, -x_plus), 0.0).sum()
    l_cur = jnp.where(delta_i > 0, lp, lm)
    return 1.0 - l_cur / (lp + lm)


def overall_probability(ct: CellTables, sigma, delta, eta,
                        read_mask, site_mask) -> jnp.ndarray:
    """cal_overall_probability (phase.rs:257-276): Σ log10 aki over
    phase-site cells of assigned active reads."""
    m = site_mask[None, :] & ct.exists & read_mask[:, None]
    x = jnp.where(eta[None, :] == 0, sigma[:, None] * delta[None, :],
                  eta[None, :] * jnp.ones_like(sigma)[:, None])
    return jnp.where(m, _cell_term(ct, x), 0.0).sum()
