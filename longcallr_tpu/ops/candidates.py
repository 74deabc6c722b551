"""Candidate SNP selection: fused per-column JAX kernel + host dense filter.

Redesign of ``longcallR/src/candidate.rs:54-528``
(SNPFrag::get_candidate_snps). The reference walks columns in a scalar loop
with ragged per-column qual vectors; here every column of a (padded) region
is evaluated simultaneously: major-allele selection, the filter chain, the
3-genotype likelihood (from the pileup's pre-folded f64 log-qual sums),
QUAL/GQ, and the edit/somatic/hom/het classification all run as one jitted
elementwise program, so XLA fuses the whole chain into a single pass over
HBM. The two dense-window passes operate on the tiny sorted candidate list
and stay on host (candidate.rs:471-523).

Decision-relevant dtypes mirror the reference: allele frequencies and SOR in
f32, likelihood math in f64 (the per-column cost is a handful of flops).
"""

from __future__ import annotations

import math
import os as _os
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Tuple

from .. import _jaxcfg  # noqa: F401  (x64 before any trace)
import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import binom as _scipy_binom

from ..config import CallerConfig
from ..tiles.pileup import PileupTensors
from ..utils.device import small_problem_device

# --- constants ---
_THETA = 0.001
_PRIOR_LOG10 = (
    math.log10(_THETA / 2.0),      # hom var
    math.log10(_THETA),            # het var
    math.log10(1.0 - 1.5 * _THETA),  # hom ref
)
_LOG10_2 = math.log10(2.0)

# Two-tailed binomial(p=.5) test table for n<=30 (candidate.rs:37-47 uses the
# statrs CDF; scipy's is the same regularized incomplete beta).
_N = 31
_BINOM_CDF = np.zeros((_N, _N + 1), dtype=np.float64)
for _n in range(_N):
    _BINOM_CDF[_n, : _n + 1] = _scipy_binom.cdf(np.arange(_n + 1), _n, 0.5)
    _BINOM_CDF[_n, _n + 1:] = 1.0


def _binom_two_tailed_table() -> np.ndarray:
    """p_two_tail[n, k] for successes k of n trials at p=0.5."""
    tbl = np.zeros((_N, _N), dtype=np.float64)
    for n in range(_N):
        for k in range(n + 1):
            if k == 0:
                p = 2.0 * _BINOM_CDF[n, 0]
            elif k == n:
                p = 2.0 * (1.0 - (_BINOM_CDF[n, n - 1] if n >= 1 else 0.0))
            else:
                p = 2.0 * min(_BINOM_CDF[n, k], 1.0 - _BINOM_CDF[n, k - 1])
            tbl[n, k] = p
    return tbl


_BINOM_TWO_TAILED = _binom_two_tailed_table()


def _div32(a, b):
    """IEEE (correctly rounded) f32 quotient of f32 operands on every
    placement: a GPU's f32 division may be off by an ulp, which moves a
    printed AF across a rounding edge. The f64 quotient rounded to f32 is
    the correctly rounded f32 quotient (53 >= 2·24 + 2 bits, so the double
    rounding is innocuous), i.e. bit-identical to the CPU's f32 division."""
    f32 = jnp.float32
    a, b = a.astype(f32), b.astype(f32)
    return (a.astype(jnp.float64) / b.astype(jnp.float64)).astype(f32)


def _sor_f32(ref_fw, ref_rv, alt_fw, alt_rv):
    """GATK-style strand odds ratio with +1 pseudocounts, computed in f32
    exactly like candidate.rs:24-35."""
    f32 = jnp.float32
    x00 = (ref_fw + 1).astype(f32)
    x01 = (ref_rv + 1).astype(f32)
    x10 = (alt_fw + 1).astype(f32)
    x11 = (alt_rv + 1).astype(f32)
    sym = _div32(x00 * x11, x01 * x10) + _div32(x01 * x10, x00 * x11)
    ref_ratio = _div32(jnp.minimum(x00, x01), jnp.maximum(x00, x01))
    alt_ratio = _div32(jnp.minimum(x10, x11), jnp.maximum(x10, x11))
    return jnp.log(sym) + jnp.log(ref_ratio) - jnp.log(alt_ratio)


SOR_THRESHOLD = float(np.float32(
    np.log(np.float32((6.0 * 2.0) / (6.0 * 10.0) + (6.0 * 10.0) / (6.0 * 2.0)))
    + np.log(np.float32(6.0 / 6.0)) - np.log(np.float32(2.0 / 10.0))
))  # cal_strand_odds_ratio(5,5,9,1), candidate.rs:49-51

# allele ASCII codes
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@partial(jax.jit, static_argnames=("cfg",))
def candidate_kernel(cols: dict, cfg: CallerConfig) -> dict:
    """Evaluate every pileup column; returns per-column category + fields.

    ``cols``: cnt[P,4] i32, n_del[P], n_intron[P], ts[P,2], strands[P,4,2],
    s_err[P,4] f64, s_1merr[P,4] f64, bq_pass[P,4] i32, ref_idx[P] i8
    (0-3 for uppercase ACGT else -1), exon_mask[P] bool.

    Category codes: 0 skip, 1 rna-edit, 2 somatic-candidate, 3 hom(/tri), 4 het.
    """
    cnt = cols["cnt"].astype(jnp.int64)          # [P,4]
    P = cnt.shape[0]
    ref_idx = cols["ref_idx"].astype(jnp.int32)  # [P]
    cov = cnt.sum(axis=1)                        # total_allele_count
    f32 = jnp.float32

    # --- two major alleles with ref-promotion quirk (util.rs:162-176) ---
    # stable desc sort by count, ties broken by allele order A<C<G<T
    key = cnt * 4 + (3 - jnp.arange(4, dtype=jnp.int64))[None, :]
    ordk = jnp.argsort(-key, axis=1)             # [P,4] allele indices
    scnt = jnp.take_along_axis(cnt, ordk, axis=1)
    x0, x1, x2, x3 = (ordk[:, i].astype(jnp.int32) for i in range(4))
    c0, c1_, c2_, c3_ = (scnt[:, i] for i in range(4))
    top2_has_ref = (x0 == ref_idx) | (x1 == ref_idx)
    promo2 = (~top2_has_ref) & (c2_ == c1_) & (x2 == ref_idx)
    promo3 = (~top2_has_ref) & (~promo2) & (c3_ == c1_) & (x3 == ref_idx)
    a1 = x0
    n1 = c0
    a2 = jnp.where(promo2, x2, jnp.where(promo3, x3, x1))
    n2 = jnp.where(promo2, c2_, jnp.where(promo3, c3_, c1_))
    f1 = _div32(n1, cov)
    f2 = _div32(n2, cov)

    # --- ref / alt roles (candidate.rs:100-130) ---
    a1_is_ref = a1 == ref_idx
    a2_is_ref = a2 == ref_idx
    alt_num = jnp.where(a1_is_ref | a2_is_ref, 1, 2)
    # alt allele 0: the non-ref major (alt_num==1) or a1 (alt_num==2)
    alt0 = jnp.where(a1_is_ref, a2, a1)
    alt0_cnt = jnp.where(a1_is_ref, n2, n1)
    alt0_freq = jnp.where(a1_is_ref, f2, f1)
    alt1 = a2
    alt1_freq = f2

    ref_valid = ref_idx >= 0  # uppercase ACGT only (see module docstring)

    # --- filter chain (each term mirrors a `continue`) ---
    keep = cols["exon_mask"]
    keep &= (cov >= cfg.min_depth) & (cov <= cfg.max_depth)
    low1 = (alt_num == 1) & (cov < 200) & (alt0_freq < f32(cfg.low_allele_frac_cutoff))
    low2 = (alt_num == 1) & (cov >= 200) & (alt0_cnt < cfg.low_allele_cnt_cutoff)
    keep &= ~(low1 | low2)
    keep &= cols["n_del"].astype(jnp.int64) < alt0_cnt          # candidate.rs:165-168
    depth_ii = (cov + cols["n_del"] + cols["n_intron"]).astype(f32)
    keep &= _div32(n1 + n2, depth_ii) >= f32(cfg.min_allele_freq_include_intron)

    # baseq pass: first non-ref major allele needs >=2 high-qual bases
    bqp = cols["bq_pass"]
    chk_allele = jnp.where(~a1_is_ref, a1, a2)
    chk_cnt = jnp.where(~a1_is_ref, n1, n2)
    chk_applies = (~a1_is_ref) | (~a2_is_ref)
    chk_bqp = jnp.take_along_axis(bqp, chk_allele[:, None].astype(jnp.int32), axis=1)[:, 0]
    keep &= ~(chk_applies & (chk_cnt > 0) & (chk_bqp < 2))

    # --- strand bias (candidate.rs:199-234) ---
    if cfg.strand_bias:
        st = cols["strands"].astype(jnp.int64)  # [P,4,2]
        take = lambda ai: (
            jnp.take_along_axis(st[:, :, 0], ai[:, None].astype(jnp.int32), axis=1)[:, 0],
            jnp.take_along_axis(st[:, :, 1], ai[:, None].astype(jnp.int32), axis=1)[:, 0],
        )
        # reference allele strands: when alt_num==2 the "reference allele" has
        # count 0 but its strands are still looked up by ref base
        ref_a = jnp.where(a1_is_ref, a1, jnp.where(a2_is_ref, a2, jnp.maximum(ref_idx, 0)))
        rf, rr = take(ref_a)
        af0, ar0 = take(alt0)
        sor0 = _sor_f32(rf, rr, af0, ar0)
        af1, ar1 = take(alt1)
        sor1 = _sor_f32(rf, rr, af1, ar1)
        sor = jnp.where(alt_num == 2, jnp.maximum(sor0, sor1), sor0)
        keep &= ~(sor > f32(SOR_THRESHOLD))
        # binomial two-tailed for <=30 alt reads (alt_num==1 only)
        ntr = (af0 + ar0).astype(jnp.int32)
        ksucc = af0.astype(jnp.int32)
        tbl = jnp.asarray(_BINOM_TWO_TAILED)
        pbin = tbl[jnp.clip(ntr, 0, 30), jnp.clip(ksucc, 0, 30)]
        keep &= ~((alt_num == 1) & (ntr <= 30) & (pbin < 0.05))
        keep &= ~((alt_num == 1) & (af0 * ar0 == 0))

    keep &= ref_valid

    # --- genotype likelihood (candidate.rs:236-335), f64 ---
    s_err = cols["s_err"]
    s_1m = cols["s_1merr"]
    ridx = jnp.maximum(ref_idx, 0)[:, None].astype(jnp.int32)
    is_ref_ch = jnp.arange(4)[None, :] == ridx          # [P,4]
    ll0 = jnp.sum(jnp.where(is_ref_ch, s_err, s_1m), axis=1)
    ll2 = jnp.sum(jnp.where(is_ref_ch, s_1m, s_err), axis=1)
    ll1 = -cov.astype(jnp.float64) * _LOG10_2
    lls = jnp.stack([ll0, ll1, ll2], axis=1)            # [P,3]
    # All normalisations below run in log domain: numerically identical to
    # the reference's 10**x/Σ form in f64 (entries >17 decades below the max
    # are invisible to the f64 sum either way) — exponents are clamped to
    # [-20, 0].
    def _log10_norm(lx):
        m = lx.max(axis=1, keepdims=True)
        s = jnp.sum(10.0 ** jnp.maximum(lx - m, -20.0), axis=1, keepdims=True)
        return (lx - m) - jnp.log10(s)

    lp = lls + jnp.asarray(_PRIOR_LOG10, dtype=jnp.float64)[None, :]
    lvp = _log10_norm(lp)
    # reference: -10*log10(max(1e-300, vp[2])) (candidate.rs:312)
    variant_quality = -10.0 * jnp.maximum(-300.0, lvp[:, 2])
    lgp = _log10_norm(lls)
    phred = -10.0 * lgp
    # replicate the reference's f64 underflow: gp below the smallest
    # subnormal prints GQ=inf (candidate.rs:319-335)
    phred = jnp.where(phred > 3233.06, jnp.inf, phred)
    ph_sorted = jnp.sort(phred, axis=1)
    genotype_quality = ph_sorted[:, 1] - ph_sorted[:, 0]
    gp = 10.0 ** jnp.maximum(lgp, -20.0)

    # variant type via strict comparisons (candidate.rs:359-371); done on the
    # log values (monotonic; differs from the 10**x form only on 1-ulp ties)
    vt = jnp.where(
        (lgp[:, 0] > lgp[:, 1]) & (lgp[:, 0] > lgp[:, 2]), 2,
        jnp.where((lgp[:, 1] > lgp[:, 0]) & (lgp[:, 1] > lgp[:, 2]), 1, 0),
    ).astype(jnp.int32)
    genotype = jnp.where(vt == 2, -1, jnp.where(vt == 1, 0, 1)).astype(jnp.int32)

    keep &= variant_quality >= jnp.float64(cfg.min_qual)

    # --- classification (candidate.rs:379-455), in branch order ---
    ts_f = cols["ts"][:, 0].astype(jnp.int64)
    ts_r = cols["ts"][:, 1].astype(jnp.int64)
    ts_zero = (ts_f == 0) & (ts_r == 0)
    is_edit_ag = (ref_idx == 0) & (alt0 == 2) & ((ts_f > ts_r * 2) | ts_zero) & (vt != 2)
    is_edit_tc = (ref_idx == 3) & (alt0 == 1) & ((ts_r > ts_f * 2) | ts_zero) & (vt != 2)
    is_edit = is_edit_ag | is_edit_tc
    is_somatic = (~is_edit) & (alt_num == 1) & (alt0_freq < f32(cfg.min_allele_freq))
    rest = (~is_edit) & (~is_somatic)
    tri_from_hom = rest & (vt == 2) & (alt_num == 2) & \
        (alt0_freq >= f32(cfg.min_allele_freq)) & (alt1_freq >= f32(cfg.min_allele_freq))
    tri_from_het = rest & (vt == 1) & (alt_num == 2)
    is_hom = rest & ((vt == 2) | tri_from_het)
    is_het = rest & (vt == 1) & (alt_num == 1)
    vt_out = jnp.where(tri_from_hom | tri_from_het, 3, vt)
    geno_out = jnp.where(tri_from_hom | tri_from_het, -1, genotype)

    category = jnp.where(
        ~keep, 0,
        jnp.where(is_edit, 1,
                  jnp.where(is_somatic, 2,
                            jnp.where(is_hom, 3, jnp.where(is_het, 4, 0)))))

    return dict(
        category=category.astype(jnp.int8),
        variant_type=vt_out.astype(jnp.int8),
        genotype=geno_out.astype(jnp.int8),
        allele1=a1.astype(jnp.int8), allele2=a2.astype(jnp.int8),
        freq1=f1, freq2=f2,
        alt0_freq=alt0_freq, alt1_freq=jnp.where(alt_num == 2, alt1_freq, f32(0)),
        alt_num=alt_num.astype(jnp.int8),
        depth=cov.astype(jnp.int32),
        variant_quality=variant_quality,
        genotype_quality=genotype_quality,
        genotype_prob=gp,
    )


@dataclass
class CandidateSet:
    """Struct-of-arrays over candidate SNPs of one region, position-sorted
    (the CandidateSNP vec equivalent, snp.rs:39-90)."""

    chrom: str
    pos: np.ndarray              # [n] int64, 0-based
    ref_base: np.ndarray         # [n] uint8 ASCII
    alleles: np.ndarray          # [n,2] uint8 ASCII (major, minor)
    allele_freqs: np.ndarray     # [n,2] float32
    alt_frac: np.ndarray         # [n,2] float32
    depth: np.ndarray            # [n] int32
    variant_quality: np.ndarray  # [n] float64
    genotype_quality: np.ndarray  # [n] float64
    genotype_prob: np.ndarray    # [n,3] float64
    variant_type: np.ndarray     # [n] int8 (0 homref,1 het,2 hom,3 tri)
    genotype: np.ndarray         # [n] int8 (eta: -1 homvar, 0 het, 1 homref)
    haplotype: np.ndarray        # [n] int8 (delta: +-1, 0 unassigned)
    rna_editing: np.ndarray      # [n] bool
    cand_somatic: np.ndarray     # [n] bool
    dense: np.ndarray            # [n] bool
    hom_var: np.ndarray          # [n] bool
    het_var: np.ndarray          # [n] bool
    for_phasing: np.ndarray      # [n] bool
    single: np.ndarray           # [n] bool
    non_selected: np.ndarray     # [n] bool
    somatic: np.ndarray          # [n] bool
    somatic_score: np.ndarray    # [n] float64
    phase_score: np.ndarray      # [n] float64
    phase_set: np.ndarray        # [n] uint32

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def idx_of(self, kind: str) -> np.ndarray:
        if kind == "het":
            return np.nonzero(self.het_var & ~self.dense)[0]
        if kind == "hom":
            return np.nonzero(self.hom_var & ~self.dense)[0]
        if kind == "edit":
            return np.nonzero(self.rna_editing)[0]
        if kind == "somatic":
            return np.nonzero(self.cand_somatic)[0]
        raise KeyError(kind)


def dense_mask(pos: np.ndarray, win: int, min_cnt: int, strict: bool) -> np.ndarray:
    """One dense-window pass over sorted candidate positions
    (candidate.rs:471-497 with ``diff > win``; the hard-coded second pass
    uses ``diff >= win`` — ``strict=False``). The tail case marks [i, j)
    with j = n-1, i.e. never the last element (reference quirk).

    Vectorised (searchsorted + interval-difference sweep) — the reference's
    nested scan is O(n·w) and a pathological cluster of thousands of
    candidates (exactly what this filter exists for) went quadratic in
    interpreter time. ``tests/oracle_candidates.dense_mask_scalar`` keeps
    the literal transcription as the comparison oracle."""
    n = len(pos)
    if n == 0:
        return np.zeros(0, dtype=bool)
    pos = np.asarray(pos, dtype=np.int64)
    # first j with pos[j]-pos[i] > win (strict) / >= win: the scan's break
    j = np.searchsorted(pos, pos + win, side="right" if strict else "left")
    # break inside the array marks [i, j) when j-i >= min_cnt; running off
    # the end (j == n) marks [i, n-1) when n-i >= min_cnt
    end = np.where(j < n, j, n - 1)
    cnt = np.where(j < n, j, n) - np.arange(n)
    starts = np.nonzero((cnt >= min_cnt) & (end > np.arange(n)))[0]
    diff = np.zeros(n + 1, dtype=np.int32)
    np.add.at(diff, starts, 1)
    np.add.at(diff, end[starts], -1)
    return np.cumsum(diff[:-1]) > 0


def _round_up(n: int, mult: int = 512) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _kernel_cols(pileup: PileupTensors,
                 exon_mask: Optional[np.ndarray]) -> dict:
    """Unpadded per-column kernel inputs for one region."""
    P = pileup.length
    ref_idx = np.full(P, -1, dtype=np.int8)
    rb = pileup.ref_base
    for i, ch in enumerate(b"ACGT"):
        ref_idx[rb == ch] = i
    em = np.ones(P, dtype=bool) if exon_mask is None else exon_mask
    return dict(
        cnt=pileup.cnt, n_del=pileup.n_del,
        n_intron=pileup.n_intron, ts=pileup.ts,
        strands=pileup.strands, s_err=pileup.s_err,
        s_1merr=pileup.s_1merr, bq_pass=pileup.bq_pass,
        ref_idx=ref_idx, exon_mask=em,
    )


def _pad_cols(cols: dict, Ppad: int) -> dict:
    P = len(cols["ref_idx"])
    pad2 = lambda a: np.pad(a, [(0, Ppad - P)] + [(0, 0)] * (a.ndim - 1))
    out = {k: pad2(v) for k, v in cols.items()}
    out["ref_idx"] = np.pad(cols["ref_idx"], (0, Ppad - P),
                            constant_values=-1)
    return out


# column budget per batched kernel dispatch (bounds the ~30 [P]-sized f64
# intermediates the kernel materialises)
CAND_BATCH_COLS = int(_os.environ.get("LONGCALLR_CAND_BATCH_COLS",
                                      str(1 << 20)))


def select_candidates_batched(pileups: List[PileupTensors],
                              cfg: CallerConfig,
                              exon_masks: Optional[List[Optional[np.ndarray]]] = None
                              ) -> List[CandidateSet]:
    """Candidate selection for many regions in few kernel dispatches: the
    kernel is purely per-column, so regions' columns concatenate along the
    position axis (padding columns have cov==0 → category 0). Chunked to
    ≤CAND_BATCH_COLS columns per dispatch; the host gather + dense-window
    passes stay per region."""
    if exon_masks is None:
        exon_masks = [None] * len(pileups)
    results: List[CandidateSet] = []
    i = 0
    n = len(pileups)
    while i < n:
        j = i + 1
        tot = pileups[i].length
        while j < n and tot + pileups[j].length <= CAND_BATCH_COLS:
            tot += pileups[j].length
            j += 1
        group = pileups[i:j]
        cols_list = [_kernel_cols(pl, em)
                     for pl, em in zip(group, exon_masks[i:j])]
        lens = [len(c["ref_idx"]) for c in cols_list]
        Ppad = _round_up(max(1, int(np.sum(lens))))
        cols = _pad_cols({k: np.concatenate([c[k] for c in cols_list])
                          for k in cols_list[0]}, Ppad)
        dev = small_problem_device(Ppad * 16)
        if dev is not None:
            with jax.default_device(dev):
                out = jax.device_get(candidate_kernel(cols, cfg))
        else:
            out = jax.device_get(candidate_kernel(cols, cfg))
        off = 0
        for pl, P in zip(group, lens):
            sl = {k: v[off:off + P] for k, v in out.items()}
            results.append(_candidates_from_out(pl, sl, cfg))
            off += P
        i = j
    return results


def select_candidates(pileup: PileupTensors, cfg: CallerConfig,
                      exon_mask: Optional[np.ndarray] = None) -> CandidateSet:
    """Full candidate selection for one region: pad → kernel → host gather →
    dense-window passes → CandidateSet."""
    P = pileup.length
    Ppad = _round_up(P)
    cols = _pad_cols(_kernel_cols(pileup, exon_mask), Ppad)
    dev = small_problem_device(Ppad * 16)
    if dev is not None:
        with jax.default_device(dev):
            out = jax.device_get(candidate_kernel(cols, cfg))
    else:
        out = jax.device_get(candidate_kernel(cols, cfg))
    return _candidates_from_out(pileup, {k: v[:P] for k, v in out.items()},
                                cfg)


def _candidates_from_out(pileup: PileupTensors, out: dict,
                         cfg: CallerConfig) -> CandidateSet:
    """Host gather of the kernel's per-column outputs (already sliced to the
    region's true length) → CandidateSet + dense-window passes."""
    P = pileup.length
    rb = pileup.ref_base
    cat = out["category"]
    sel = np.nonzero(cat != 0)[0]
    n = sel.shape[0]
    start0 = pileup.region.start - 1
    cat_s = cat[sel]
    cs = CandidateSet(
        chrom=pileup.region.chr,
        pos=(sel + start0).astype(np.int64),
        ref_base=rb[sel].copy(),
        alleles=np.stack([_ACGT[out["allele1"][sel]], _ACGT[out["allele2"][sel]]], axis=1),
        allele_freqs=np.stack([out["freq1"][sel], out["freq2"][sel]], axis=1),
        alt_frac=np.stack([out["alt0_freq"][sel], out["alt1_freq"][sel]], axis=1),
        depth=out["depth"][sel],
        variant_quality=out["variant_quality"][sel],
        genotype_quality=out["genotype_quality"][sel],
        genotype_prob=out["genotype_prob"][sel],
        variant_type=out["variant_type"][sel],
        genotype=out["genotype"][sel],
        haplotype=np.zeros(n, np.int8),
        rna_editing=cat_s == 1,
        cand_somatic=cat_s == 2,
        dense=np.zeros(n, bool),
        hom_var=cat_s == 3,
        het_var=cat_s == 4,
        for_phasing=(cat_s == 3) | (cat_s == 4),
        single=np.zeros(n, bool),
        non_selected=np.zeros(n, bool),
        somatic=np.zeros(n, bool),
        somatic_score=np.zeros(n, np.float64),
        phase_score=np.zeros(n, np.float64),
        phase_set=np.zeros(n, np.uint32),
    )
    # dense-window passes over hom+het candidates (position order)
    ph_idx = np.nonzero(cs.hom_var | cs.het_var)[0]
    if ph_idx.size:
        ppos = cs.pos[ph_idx]
        d = dense_mask(ppos, cfg.dense_win_size, cfg.min_dense_cnt, strict=True)
        d |= dense_mask(ppos, 5, 3, strict=False)
        cs.dense[ph_idx[d]] = True
        cs.for_phasing[ph_idx[d]] = False
    return cs
