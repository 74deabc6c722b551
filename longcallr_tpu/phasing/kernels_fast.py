"""Matvec-form phasing half-steps (the memory-bandwidth-bound path).

The masked log-emission sums of the coordinate ascent decompose exactly over
three fixed matrices (per region, per ascent call):

    B = m ∘ lerr,   Dif = m ∘ (l1m - lerr),   Dp = m ∘ (l1m - lerr) ∘ p

with m the phase-site cell mask. Using match(x) = (1 + p·x)/2 on masked
cells (p ∈ {±1} there):

    L(σ=s)[k]  = rowB[k] + ½·rowDif[k] + ½·(s·(Dp u)[k] + (Dp v)[k])
    S_match[i] = colB[i] + ½·colDif[i] + ½·δ_i·(Dpᵀ σ)[i]
    S_flip[i]  = colB[i] + ½·colDif[i] − ½·δ_i·(Dpᵀ σ)[i]
    S_refe[i]  = colB[i] + ½·colDif[i] + ½·colDp[i]
    S_alte[i]  = colB[i] + ½·colDif[i] − ½·colDp[i]

where u_i = [η_i==0]·δ_i and v_i = [η_i≠0]·η_i. One ascent iteration costs
two matvecs with Dp (u/v fold into one fused pass) instead of ~8 full-matrix
elementwise passes — ~3× less HBM traffic, and the enumeration path's many
configs turn the matvec into a genuine [K,I]×[I,C] matmul.

Numerically this reorders the f64 summation relative to the reference-form
kernels (products summed instead of selected terms), so results agree to
~1e-12 relative but can differ on exact ties; it is therefore an opt-in
execution mode (LONGCALLR_FAST_KERNELS=1 or cfg), with the reference-form
kernels remaining the specification.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from .. import _jaxcfg  # noqa: F401  (x64 before any trace)
import jax
import jax.numpy as jnp

from .kernels import (TIE_TOL, CellTables, PRIOR_HOMREF_LOG,
                      PRIOR_HOMVAR_LOG, _LOG10_HALF, _PRIOR_HET_BASE, f64)


class FastTables(NamedTuple):
    """Precomputed reductions for one ascent call (fixed masks)."""

    dp: jnp.ndarray       # [K,I] m∘diff∘p
    row_b: jnp.ndarray    # [K] Σ_i m∘lerr
    row_dif: jnp.ndarray  # [K] Σ_i m∘diff
    col_b: jnp.ndarray    # [I] Σ_k mS∘lerr
    col_dif: jnp.ndarray  # [I] Σ_k mS∘diff
    col_dp: jnp.ndarray   # [I] Σ_k mS∘diff∘p
    row_cells: jnp.ndarray  # [K] phase-site cell count per read
    cov: jnp.ndarray      # [I] gathered cell count per SNP (over mS)
    read_mask: jnp.ndarray  # [K] the ascent's active read set


def make_fast_tables(ct: CellTables, read_mask, site_mask) -> FastTables:
    """Build the fixed reductions. ``read_mask`` must be the ascent's active
    read set (read_base & σ≠0 — constant during cross_optimize since σ only
    flips sign)."""
    m = site_mask[None, :] & ct.exists
    diff = jnp.where(m, ct.l1m - ct.lerr, 0.0)
    lerr = jnp.where(m, ct.lerr, 0.0)
    dp = diff * ct.p
    ms = m & read_mask[:, None]
    return FastTables(
        dp=dp,
        row_b=lerr.sum(axis=1),
        row_dif=diff.sum(axis=1),
        col_b=jnp.where(ms, ct.lerr, 0.0).sum(axis=0),
        col_dif=jnp.where(ms, diff, 0.0).sum(axis=0),
        col_dp=jnp.where(ms, dp, 0.0).sum(axis=0),
        row_cells=m.sum(axis=1),
        cov=ms.sum(axis=0),
        read_mask=read_mask,
    )


def fast_read_logliks(ft: FastTables, delta, eta) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(L(+1), L(-1), cell counts) per read — matvec form. u and v stack
    into one [I,2] operand so Dp streams from HBM once per call."""
    u = jnp.where(eta == 0, delta, 0.0)
    v = jnp.where(eta == 0, 0.0, eta)
    duv = ft.dp @ jnp.stack([u, v], axis=-1)
    du, dv = duv[:, 0], duv[:, 1]
    base = ft.row_b + 0.5 * ft.row_dif + 0.5 * dv
    return base + 0.5 * du, base - 0.5 * du, ft.row_cells


def fast_snp_sums(ft: FastTables, sigma, delta):
    """(S_match, S_flip, S_refe, S_alte, cov) per SNP — one matvec.
    Inactive reads' σ must not contribute (the column sums are over the
    active-read mask)."""
    dts = ft.dp.T @ jnp.where(ft.read_mask, sigma, 0.0)
    base = ft.col_b + 0.5 * ft.col_dif
    half = 0.5 * delta * dts
    s_match = base + half
    s_flip = base - half
    s_refe = base + 0.5 * ft.col_dp
    s_alte = base - 0.5 * ft.col_dp
    return s_match, s_flip, s_refe, s_alte, ft.cov


def fast_overall_probability(ft: FastTables, sigma, delta, eta) -> jnp.ndarray:
    """cal_overall_probability in matvec form over the active-read set."""
    u = jnp.where(eta == 0, delta, 0.0)
    v = jnp.where(eta == 0, 0.0, eta)
    duv = ft.dp @ jnp.stack([u, v], axis=-1)
    du, dv = duv[:, 0], duv[:, 1]
    per_read = ft.row_b + 0.5 * ft.row_dif + 0.5 * (sigma * du + dv)
    return jnp.where(ft.read_mask, per_read, 0.0).sum()


# ---------------------------------------------------------------------------
# hi/lo f32-split mode: the Dp matvecs as f32 contractions
# ---------------------------------------------------------------------------
#
# For devices without a fast f64 datapath. In split mode Dp is stored as an
# exact two-term f32 sum (dp = hi + lo with hi = f32(dp), lo = f32(dp − hi);
# |lo| ≤ ulp(hi), so the representation is f64-exact to ~2⁻⁴⁸ relative) and
# each matvec runs as two f32 contractions whose partials are combined in
# f64. The contraction axis is chunked (F32_CHUNK) so f32 accumulation error
# stays bounded by ~chunk·2⁻²⁴ per partial before the exact f64 chunk-sum;
# the sigma/delta/eta operands are in {−1, 0, +1} and therefore f32-exact.
# That bound holds only if every f32 product is exact, so every contraction
# here states precision=HIGHEST: at default precision a GPU may run f32
# matmuls in TF32 (~10 mantissa bits), which breaks the bound by orders of
# magnitude.
#
# Accuracy: sums agree with the f64 kernels to ~1e-4 absolute (vs magnitudes
# of 1–10³), which can flip near-tie ascent decisions; the optimizer's
# keep-best-by-objective structure makes the final states equivalent in
# practice (equivalence-tested end to end). Opt-in: LONGCALLR_F32_KERNELS=1
# on top of LONGCALLR_FAST_KERNELS=1.

F32_CHUNK = 512
f32 = jnp.float32
_HIGHEST = jax.lax.Precision.HIGHEST


class FastTables32(NamedTuple):
    """FastTables with Dp in hi/lo f32-split form (vectors stay f64 — they
    are built once per ascent call; the per-iteration matvecs are the hot
    path). The two halves are stored STACKED ([2,K,I], dp2[0]=hi,
    dp2[1]=lo) so each matvec direction is ONE einsum kernel over both
    halves instead of two back-to-back kernels — same HBM bytes, half the
    kernel launches per ascent iteration."""

    dp2: jnp.ndarray      # [2,K,I] f32; dp == dp2[0] + dp2[1] in f64
    row_b: jnp.ndarray
    row_dif: jnp.ndarray
    col_b: jnp.ndarray
    col_dif: jnp.ndarray
    col_dp: jnp.ndarray
    row_cells: jnp.ndarray
    cov: jnp.ndarray
    read_mask: jnp.ndarray


def split_f32(a: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    hi = a.astype(f32)
    lo = (a - hi.astype(f64)).astype(f32)
    return hi, lo


def make_fast_tables32(ct: CellTables, read_mask, site_mask) -> FastTables32:
    ft = make_fast_tables(ct, read_mask, site_mask)
    hi, lo = split_f32(ft.dp)
    return FastTables32(jnp.stack([hi, lo]), ft.row_b, ft.row_dif, ft.col_b,
                        ft.col_dif, ft.col_dp, ft.row_cells, ft.cov,
                        ft.read_mask)


# f32-split emission tables (numpy at module level — a jnp constant would
# initialise the device backend at import, see kernels.py). diff = l1m−lerr;
# each f64 table value is an exact two-term f32 sum hi+lo.
import numpy as _np
from .kernels import LOG10_1MERR_T, LOG10_ERR_T
from ..config import MAX_BASE_QUALITY as _MAXQ

_DIFF_NP = LOG10_1MERR_T - LOG10_ERR_T
_DIFF_HI_NP = _DIFF_NP.astype(_np.float32)
with _np.errstate(invalid="ignore"):
    _DIFF_LO_NP = (_DIFF_NP - _DIFF_HI_NP.astype(_np.float64)).astype(_np.float32)


def _tiny_table_lookup(q8, table_np):
    """Gather-free lookup from a ≤31-entry f32 table: a compare+select
    chain over the table entries is elementwise work that fuses with its
    consumers, where a gather over [B,K,I] indices is a separate pass.
    q8 values above the table range resolve to the LAST entry (same clamp
    semantics as expand_cells' jnp.minimum + clipped gather)."""
    out = jnp.full(q8.shape, jnp.float32(table_np[len(table_np) - 1]), f32)
    for v in range(len(table_np) - 1):
        out = jnp.where(q8 == v, jnp.float32(table_np[v]), out)
    return out


def _ones_sum_rows(a32):
    """Σ over the minor axis of [K,I] f32 via a ones-contraction,
    F32_CHUNK-chunked f32 partials combined in f64 (same accumulation
    contract as the split matvecs)."""
    K, I = a32.shape
    c = _chunks(I)
    parts = jnp.einsum("kjc,c->kj", a32.reshape(K, I // c, c),
                       jnp.ones(c, f32), preferred_element_type=f32,
                       precision=_HIGHEST)
    return parts.astype(f64).sum(axis=1)


def _ones_sum_cols(a32):
    """Σ over the major axis of [K,I] f32 (see _ones_sum_rows)."""
    K, I = a32.shape
    c = _chunks(K)
    parts = jnp.einsum("jci,c->ji", a32.reshape(K // c, c, I),
                       jnp.ones(c, f32), preferred_element_type=f32,
                       precision=_HIGHEST)
    return parts.astype(f64).sum(axis=0)


def fast_tables32_from_compact(cc, read_mask, site_mask) -> FastTables32:
    """FastTables32 built DIRECTLY from CompactCells: f32 table lookups and
    ones-contractions, no [K,I] f64 intermediate anywhere (the
    expand-then-split build, expand_cells + make_fast_tables32, makes
    several f64 passes over [K,I]).

    Exactness vs the expand-then-split build:
      * dp2 is BIT-IDENTICAL: f32(diff·p) == f32(diff)·p for p ∈ {±1}.
      * row_b/col_b are exact sums in one final rounding (lerr = −q/10
        exactly, so the masked sums are integer q-sums — f32-exact up to
        2²⁴ — scaled by −0.1 in f64); differs from the f64 term-sum by
        ≤1 ulp.
      * row_dif/col_dif/col_dp use f32-chunked partials with f64 chunk
        combine (~1e-4 absolute) — the same accumulation contract as the
        split matvecs, inside the mode's documented error bound and the
        F32_SAFETY_TOL margin recheck.
    Only reachable in f32 mode (optimize._fast_tables_for), where these
    tolerances are already the operating contract."""
    p8, q8 = cc.p, cc.q
    K, I = p8.shape
    exists = p8 != 0
    m = site_mask[None, :] & exists
    ms = m & read_mask[:, None]
    qi = jnp.minimum(q8.astype(jnp.int32), _MAXQ)
    dif_hi = _tiny_table_lookup(qi, _DIFF_HI_NP)
    dif_lo = _tiny_table_lookup(qi, _DIFF_LO_NP)
    p32 = p8.astype(f32)
    dp_hi = jnp.where(m, dif_hi * p32, 0.0).astype(f32)
    dp_lo = jnp.where(m, dif_lo * p32, 0.0).astype(f32)
    qf = qi.astype(f32)
    zero = jnp.asarray(0.0, f32)
    qm = jnp.where(m, qf, zero)
    qms = jnp.where(ms, qf, zero)
    dif_hi_m = jnp.where(m, dif_hi, zero)
    dif_lo_m = jnp.where(m, dif_lo, zero)
    dif_hi_ms = jnp.where(ms, dif_hi, zero)
    dif_lo_ms = jnp.where(ms, dif_lo, zero)
    dp_hi_ms = jnp.where(read_mask[:, None], dp_hi, zero)
    dp_lo_ms = jnp.where(read_mask[:, None], dp_lo, zero)
    row_b = -0.1 * _ones_sum_rows(qm)
    row_dif = _ones_sum_rows(dif_hi_m) + _ones_sum_rows(dif_lo_m)
    col_b = -0.1 * _ones_sum_cols(qms)
    col_dif = _ones_sum_cols(dif_hi_ms) + _ones_sum_cols(dif_lo_ms)
    col_dp = _ones_sum_cols(dp_hi_ms) + _ones_sum_cols(dp_lo_ms)
    row_cells = _ones_sum_rows(m.astype(f32)).astype(jnp.int32)
    cov = _ones_sum_cols(ms.astype(f32)).astype(jnp.int32)
    return FastTables32(jnp.stack([dp_hi, dp_lo]), row_b, row_dif, col_b,
                        col_dif, col_dp, row_cells, cov, read_mask)


def _chunks(n: int) -> int:
    c = min(F32_CHUNK, n)
    while n % c:          # shapes are power-of-two padded; guard odd callers
        c -= 1
    return c


def _matvec_rows(dp2, x) -> jnp.ndarray:
    """dp @ x with I-axis-chunked f32 contractions, f64 chunk accumulation.
    ``dp2`` is the stacked [2,K,I] hi/lo split; both halves contract in ONE
    einsum (the split axis rides along as a batch dim — identical partials
    to two separate kernels, one launch). ``x`` may be [I] or [I,X]
    (stacked operands — one pass over dp)."""
    _, K, I = dp2.shape
    vec = x.ndim == 1
    if vec:
        x = x[:, None]
    X = x.shape[1]
    c = _chunks(I)
    x32 = x.astype(f32).reshape(I // c, c, X)
    d = dp2.reshape(2, K, I // c, c)
    parts = jnp.einsum("skjc,jcx->skjx", d, x32, preferred_element_type=f32,
                       precision=_HIGHEST)
    out = (parts[0].astype(f64) + parts[1].astype(f64)).sum(axis=1)
    return out[:, 0] if vec else out


def _matvec_cols(dp2, s) -> jnp.ndarray:
    """dp.T @ s with K-axis-chunked f32 contractions, f64 accumulation;
    both split halves in one einsum (see _matvec_rows)."""
    _, K, I = dp2.shape
    c = _chunks(K)
    s32 = s.astype(f32).reshape(K // c, c)
    d = dp2.reshape(2, K // c, c, I)
    parts = jnp.einsum("sjci,jc->sji", d, s32, preferred_element_type=f32,
                       precision=_HIGHEST)
    return (parts[0].astype(f64) + parts[1].astype(f64)).sum(axis=0)


def fast_read_logliks32(ft: FastTables32, delta, eta):
    u = jnp.where(eta == 0, delta, 0.0)
    v = jnp.where(eta == 0, 0.0, eta)
    duv = _matvec_rows(ft.dp2, jnp.stack([u, v], axis=-1))
    du, dv = duv[:, 0], duv[:, 1]
    base = ft.row_b + 0.5 * ft.row_dif + 0.5 * dv
    return base + 0.5 * du, base - 0.5 * du, ft.row_cells


def fast_snp_sums32(ft: FastTables32, sigma, delta):
    dts = _matvec_cols(ft.dp2, jnp.where(ft.read_mask, sigma, 0.0))
    base = ft.col_b + 0.5 * ft.col_dif
    half = 0.5 * delta * dts
    return (base + half, base - half, base + 0.5 * ft.col_dp,
            base - 0.5 * ft.col_dp, ft.cov)


def fast_overall_probability32(ft: FastTables32, sigma, delta, eta):
    u = jnp.where(eta == 0, delta, 0.0)
    v = jnp.where(eta == 0, 0.0, eta)
    duv = _matvec_rows(ft.dp2, jnp.stack([u, v], axis=-1))
    du, dv = duv[:, 0], duv[:, 1]
    per_read = ft.row_b + 0.5 * ft.row_dif + 0.5 * (sigma * du + dv)
    return jnp.where(ft.read_mask, per_read, 0.0).sum()


# ---------------------------------------------------------------------------
# Device block-flip pass (cross_optimize_by_block, phase.rs:1298-1394)
# ---------------------------------------------------------------------------
#
# optimize.block_flip_pass computes every block's decision against the SAME
# current state (no sequential dependence between blocks), so the whole pass
# is column reductions + elementwise work — expressible over the split
# tables with ONE extra contraction. Per-block decision margin with a
# block-size-scaled tolerance flags near-tie regions for an exact host
# recompute (the same fail-safe shape as optimize.F32_SAFETY_TOL).
# LONGCALLR_BF_SAFETY overrides the per-site tolerance (default 1e-3; the
# split-sum error propagated through the q surrogate is ≲2e-5 per site).

import os as _os

_BF_ENV = _os.environ.get("LONGCALLR_BF_SAFETY", "")
F32_BF_TOL: float = (float(_BF_ENV) if _BF_ENV else 1e-3)

# genotype-prior constants (phase.rs:136-144): THE copies live in
# kernels.py — import, never re-derive, so a prior change cannot leave the
# device block-flip q computation out of sync with the host kernels
_LOG_P_HET = _PRIOR_HET_BASE
_LOG10_2 = _LOG10_HALF
_LOG_P_HOMREF = PRIOR_HOMREF_LOG
_LOG_P_HOMVAR = PRIOR_HOMVAR_LOG


def fast_block_flip32(ft: FastTables32, p8, sigma, delta, eta, site_mask,
                      block_id):
    """block_flip_pass (phase.rs:1298-1394) over the split tables.

    ``block_id`` is [I] int32 (−1 = unblocked column, same encoding as
    LDInfo.block_id padded to the bucket width). Returns
    (new_sigma, new_delta, margin) with ``margin`` = min over blocks of
    |Σ_block Δq| / block_size — the per-site-normalised decision margin.
    Callers compare it against F32_BF_TOL OUTSIDE the trace (so the
    tolerance never invalidates compile caches): margin < F32_BF_TOL means
    some block decision sat inside the f32 error envelope and the region's
    flip pass must be recomputed exactly on the host.

    Identities (same decomposition as the module header, x_new = σ·ff·(−δ)
    with ff = −1 exactly on cells of a read's own fully-containing block):
        S'_match = S_flip + δ·H      S'_flip = S_match − δ·H
        H[i] = Σ_k (m∘diff∘p)[k,i] · σ_k · F[k,i]
    and full containment reduces to min==max of block_id over a read's
    exist cells (blocks are disjoint column components), so the pass needs
    no gathers and no [K,I] f64 intermediates."""
    K, I = p8.shape
    exists = p8 != 0
    s_match, s_flip, s_refe, s_alte, cov = fast_snp_sums32(ft, sigma, delta)

    bid = block_id.astype(jnp.int32)
    bmin = jnp.where(exists, bid[None, :], jnp.int32(I + 1)).min(axis=1)
    bmax = jnp.where(exists, bid[None, :], jnp.int32(-2)).max(axis=1)
    full_in = jnp.where((bmin == bmax) & (bmax >= 0), bmax, jnp.int32(-1))
    F = (full_in[:, None] == bid[None, :]) & (bid[None, :] >= 0)

    # the one new contraction — chunked f32 partials, f64 chunk combine
    # (identical accumulation contract to _matvec_cols)
    c = _chunks(K)
    sf = (jnp.where(ft.read_mask, sigma, 0.0).astype(f32)[:, None]
          * F.astype(f32))
    d = ft.dp2.reshape(2, K // c, c, I)
    parts = jnp.einsum("sjci,jci->sji", d, sf.reshape(K // c, c, I),
                       preferred_element_type=f32, precision=_HIGHEST)
    H = (parts[0].astype(f64) + parts[1].astype(f64)).sum(axis=0)

    s_match_new = s_flip + delta * H
    s_flip_new = s_match - delta * H

    ph = jnp.where(cov == 0, _LOG_P_HET,
                   _LOG_P_HET - cov.astype(f64) * _LOG10_2)

    def q_of(sm, sfl, e):
        n1 = jnp.where(e == 0, sm + ph,
                       jnp.where(e == 1, s_refe + _LOG_P_HOMREF,
                                 s_alte + _LOG_P_HOMVAR))
        dd = ((s_alte + _LOG_P_HOMVAR) + (sm + ph)
              + (s_refe + _LOG_P_HOMREF) + (sfl + ph))
        return 1.0 - n1 / dd

    dq = q_of(s_match_new, s_flip_new, eta) - q_of(s_match, s_flip, eta)

    # per-block Δ sums over a static NB == I one-hot (block count ≤ site
    # count, so one compiled program per bucket shape)
    onehot = ((bid[:, None] == jnp.arange(I, dtype=jnp.int32)[None, :])
              & (bid[:, None] >= 0))                        # [I cols, NB]
    dsum = jnp.where(onehot, dq[:, None], 0.0).sum(axis=0)  # [NB]
    ncols = onehot.sum(axis=0)
    has = ncols > 0

    # exact global-flip symmetry: when NO active masked cell at a block's
    # columns belongs to a partially-overlapping read (full_in ≠ block),
    # x_new == x per cell, the host's Σ Δq is EXACTLY 0.0 (bit-identical
    # sums) and it never flips (strict <). The common case — a region whose
    # reads all sit inside one dominant block — would otherwise report a
    # pure-noise margin and force a host recompute every time. The
    # predicate is integer work, so the device decision is exact too.
    m0 = exists & site_mask[None, :] & ft.read_mask[:, None]
    part = m0 & (bid[None, :] >= 0) & (full_in[:, None] != bid[None, :])
    cnt_col = part.sum(axis=0)                               # [I] int
    npart = jnp.where(onehot, cnt_col[:, None], 0).sum(axis=0)
    sym = has & (npart == 0)

    # tie-quantized accept (kernels.TIE_TOL), matching the host pass;
    # the BF-safety margin net routes near-threshold blocks to the
    # exact host recompute regardless
    flipb = has & ~sym & (dsum > TIE_TOL)
    margin = jnp.where(has & ~sym,
                       jnp.abs(dsum) / jnp.maximum(ncols.astype(f64), 1.0),
                       jnp.inf).min()

    fb_col = (onehot & flipb[None, :]).any(axis=1)
    new_delta = jnp.where(fb_col, -delta, delta)
    covers = (exists & site_mask[None, :] & F).any(axis=1)
    oneh_k = full_in[:, None] == jnp.arange(I, dtype=jnp.int32)[None, :]
    flip_read = (oneh_k & flipb[None, :]).any(axis=1) & covers & ft.read_mask
    new_sigma = jnp.where(flip_read, -sigma, sigma)
    return new_sigma, new_delta, margin
