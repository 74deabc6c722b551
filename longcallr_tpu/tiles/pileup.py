"""Pileup tensorization: BAM reads → dense per-region column tensors.

Redesign of the reference pileup engine
(``longcallR/src/util.rs:614-950`` Profile::fill_data_into_freq_vec). Instead
of a ``Vec<BaseFreq>`` of per-column Vec-of-quals, each region produces fixed
layout numpy tensors; per-base quality log-terms are folded at scatter time
into per-(column, allele) float64 sums so the downstream genotype-likelihood
becomes a few flops per column in a single fused JAX kernel (no ragged data
ever reaches the device).

Semantics replicated exactly (see file:line cites inline):
  * base quality capped at 30 before the error-rate table (main.rs:20);
  * ONT read-end trimming within ``distance_to_read_end`` of the aligned
    start/end boundaries (util.rs:745-751), platform-gated;
  * poly-A / homopolymer masking near read ends: any fully-homopolymer window
    of length ``polya_tail_length`` starting within [j-L, j+1], checked
    against the *current column's* ref base (util.rs:754-789);
  * insertions counted at the previous column, only when it is inside the
    window (util.rs:918-929); introns (N) and deletions (D) per column;
  * transcript-strand counts from the ``ts`` tag combined with read strand
    (util.rs:803-819); forward/backward counts incremented for every kept
    base including non-ACGT ones (util.rs:894-898).

The per-column ``distance_to_end`` lists the reference collects are dead data
(never consumed by candidate.rs) and are intentionally not materialised.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import CallerConfig, MAX_BASE_QUALITY
from ..io.bam import BamFile, BamRead
from .regions import Region

import os as _os

# read count above which the native pileup uses the chunk-parallel fill
PILEUP_MT_MIN = int(_os.environ.get("LONGCALLR_PILEUP_MT_MIN", "1024"))

# CIGAR op codes
_M, _I, _D, _N, _S, _H, _P, _EQ, _X = range(9)

# base-quality → log10 error tables, q capped at 30.
# Computed the same way as the reference: error_rate = 0.1^(q/10)
# (candidate.rs:268), log10 taken in f64.
_Q = np.arange(MAX_BASE_QUALITY + 1, dtype=np.float64)
ERR_RATE = 0.1 ** (_Q / 10.0)
with np.errstate(divide="ignore"):
    LOG10_ERR = np.log10(ERR_RATE)
    LOG10_1MERR = np.log10(1.0 - ERR_RATE)
# q=0 → err=1.0 → log10(0) = -inf; the reference hits the same -inf.

# ASCII → allele index (A=0,C=1,G=2,T=3; lowercase accepted as in the
# reference match arms 'A' | 'a' ... util.rs:821-890); others → -1
BASE_INDEX = np.full(256, -1, dtype=np.int8)
for _i, _cs in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
    for _c in _cs:
        BASE_INDEX[_c] = _i


def _ragged_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [arange(s, s+l) for s, l in zip(starts, lens)]."""
    if len(starts) == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(lens)
    total = int(ends[-1])
    return (np.arange(total, dtype=np.int64)
            - np.repeat(ends - lens, lens)
            + np.repeat(starts, lens))


@dataclass
class PileupTensors:
    """Dense per-region pileup statistics (the Profile equivalent)."""

    region: Region
    ref_base: np.ndarray      # [P] uint8 ASCII (raw case)
    cnt: np.ndarray           # [P,4] int32 allele counts (A,C,G,T)
    n_intron: np.ndarray      # [P] int32 (CIGAR N)
    n_del: np.ndarray         # [P] int32 (CIGAR D)
    n_ins: np.ndarray         # [P] int32 (insertion at previous column)
    fwd: np.ndarray           # [P] int32 forward-strand kept bases
    bwd: np.ndarray           # [P] int32 reverse-strand kept bases
    strands: np.ndarray       # [P,4,2] int32 per-allele (fwd, rev)
    ts: np.ndarray            # [P,2] int32 transcript strand (fwd, rev)
    s_err: np.ndarray         # [P,4] float64 Σ log10(err)   per allele
    s_1merr: np.ndarray       # [P,4] float64 Σ log10(1-err) per allele
    bq_pass: np.ndarray       # [P,4] int32 count of baseq ≥ min_baseq

    @property
    def length(self) -> int:
        return self.ref_base.shape[0]

    def depth_acgt(self) -> np.ndarray:
        return self.cnt.sum(axis=1)


def _empty_tensors(region: Region, ref_window: np.ndarray) -> PileupTensors:
    P = region.end - region.start
    return PileupTensors(
        region=region,
        ref_base=ref_window,
        cnt=np.zeros((P, 4), np.int32),
        n_intron=np.zeros(P, np.int32),
        n_del=np.zeros(P, np.int32),
        n_ins=np.zeros(P, np.int32),
        fwd=np.zeros(P, np.int32),
        bwd=np.zeros(P, np.int32),
        strands=np.zeros((P, 4, 2), np.int32),
        ts=np.zeros((P, 2), np.int32),
        s_err=np.zeros((P, 4), np.float64),
        s_1merr=np.zeros((P, 4), np.float64),
        bq_pass=np.zeros((P, 4), np.int32),
    )


def _homopoly_near(seq: np.ndarray, L: int) -> np.ndarray:
    """[4, len] bools: position j has a fully-homopolymer window of length L
    (for allele A/C/G/T) starting at some w in [j-L, j+1] with the window
    entirely inside the read (util.rs:758-787)."""
    n = seq.shape[0]
    out = np.zeros((4, n), dtype=bool)
    if L <= 0:
        # degenerate --polya-tail-length: the scalar window loop trivially
        # fires for L in {0, -1} on any in-bounds start (counters 0 >= L)
        # and never runs for L < -1 (empty t0 range) — native UniZone
        # keeps the same split (decode.cpp)
        out[:] = L >= -1
        return out
    if n < L:
        return out
    for ai, ch in enumerate(b"ATCG"):
        # note reference counts A,T,C,G in that order; index here by channel
        isx = (seq == ch)
        cs = np.concatenate([[0], np.cumsum(isx)])
        win = (cs[L:] - cs[:-L]) == L          # [n-L+1] windows w=0..n-L
        # any win[w] for w in [j-L, j+1] ∩ [0, n-L]
        wcs = np.concatenate([[0], np.cumsum(win)])
        j = np.arange(n)
        lo = np.clip(j - L, 0, n - L + 1)
        hi = np.clip(j + 2, 0, n - L + 1)      # exclusive
        out[ai] = (wcs[hi] - wcs[lo]) > 0
    return out


def add_read(acc: PileupTensors, read: BamRead, cfg: CallerConfig,
             min_baseq: Optional[int] = None) -> None:
    """Scatter one QC-passed read into the region accumulators."""
    region = acc.region
    start0 = region.start - 1          # 0-based first column
    P = acc.length
    seq = read.seq
    qual = read.qual
    ops = read.cigar_ops
    lens = read.cigar_lens
    lead_sc = read.leading_softclips()
    trail_sc = read.trailing_softclips()
    strand = read.strand
    mbq = cfg.min_baseq if min_baseq is None else min_baseq

    # --- cigar walk → segment lists ---
    m_q: List[int] = []
    m_r: List[int] = []
    m_l: List[int] = []
    d_r: List[int] = []
    d_l: List[int] = []
    n_r: List[int] = []
    n_l: List[int] = []
    i_r: List[int] = []
    rpos = read.pos
    qpos = lead_sc
    for op, ln in zip(ops.tolist(), lens.tolist()):
        if op in (_S, _H, _P):
            continue
        if op in (_M, _EQ, _X):
            m_q.append(qpos)
            m_r.append(rpos)
            m_l.append(ln)
            qpos += ln
            rpos += ln
        elif op == _D:
            d_r.append(rpos)
            d_l.append(ln)
            rpos += ln
        elif op == _N:
            n_r.append(rpos)
            n_l.append(ln)
            rpos += ln
        elif op == _I:
            i_r.append(rpos)
            qpos += ln
        else:
            raise ValueError(f"unknown cigar op {op}")

    # --- D / N / I scatter ---
    if d_l:
        rel = _ragged_ranges(np.asarray(d_r) - start0, np.asarray(d_l))
        rel = rel[(rel >= 0) & (rel < P)]
        np.add.at(acc.n_del, rel, 1)
    if n_l:
        rel = _ragged_ranges(np.asarray(n_r) - start0, np.asarray(n_l))
        rel = rel[(rel >= 0) & (rel < P)]
        np.add.at(acc.n_intron, rel, 1)
    if i_r:
        rel = np.asarray(i_r, dtype=np.int64) - start0
        rel = rel[(rel >= 1) & (rel < P)]  # previous column must exist (util.rs:919-921)
        np.add.at(acc.n_ins, rel - 1, 1)

    if not m_l:
        return

    # --- aligned bases ---
    q_idx = _ragged_ranges(np.asarray(m_q), np.asarray(m_l))
    rel = _ragged_ranges(np.asarray(m_r) - start0, np.asarray(m_l))
    inw = (rel >= 0) & (rel < P)
    if not inw.any():
        return

    dist = cfg.distance_to_read_end
    boundary_end = len(seq) - trail_sc
    near = (np.abs(q_idx - lead_sc) < dist) | (np.abs(q_idx - boundary_end) < dist)

    if cfg.is_ont:
        kept = inw & ~near
        if not kept.any():
            return
    else:
        kept = inw.copy()
        near_inw = near & inw
        if near_inw.any():
            L = cfg.polya_tail_length
            hp = _homopoly_near(seq, L)  # [4(A,T,C,G), len]
            R = np.zeros(q_idx.shape[0], dtype=np.uint8)
            R[inw] = acc.ref_base[rel[inw]]
            qn = q_idx
            polya = near_inw & ((hp[0, qn] & (R != ord("A")))
                                | (hp[1, qn] & (R != ord("T"))))
            homop = near_inw & ((hp[2, qn] & (R != ord("C")))
                                | (hp[3, qn] & (R != ord("G"))))
            kept &= ~(polya | homop)
        if not kept.any():
            return

    relk = rel[kept]
    qk = q_idx[kept]
    base = seq[qk]
    bq = np.minimum(qual[qk], MAX_BASE_QUALITY).astype(np.int64)
    bidx = BASE_INDEX[base]
    valid = bidx >= 0

    # transcript strand (before base validity, util.rs:803-819)
    ts_tag = read.get_tag("ts")
    if ts_tag == "+":
        ts_col = 0 if strand == 0 else 1
    elif ts_tag == "-":
        ts_col = 1 if strand == 0 else 0
    else:
        ts_col = -1
    if ts_col >= 0:
        np.add.at(acc.ts[:, ts_col], relk, 1)

    # forward/backward counts for every kept base (util.rs:894-898)
    if strand == 0:
        np.add.at(acc.fwd, relk, 1)
    else:
        np.add.at(acc.bwd, relk, 1)

    if valid.any():
        rv = relk[valid]
        bv = bidx[valid].astype(np.int64)
        qv = bq[valid]
        np.add.at(acc.cnt, (rv, bv), 1)
        np.add.at(acc.strands, (rv, bv, strand), 1)
        np.add.at(acc.s_err, (rv, bv), LOG10_ERR[qv])
        np.add.at(acc.s_1merr, (rv, bv), LOG10_1MERR[qv])
        np.add.at(acc.bq_pass, (rv, bv), (qv >= mbq).astype(np.int32))


def build_pileup(bam: BamFile, region: Region, ref_seq: np.ndarray,
                 cfg: CallerConfig,
                 qc_mask: Optional[np.ndarray] = None,
                 use_native: bool = True) -> PileupTensors:
    """Fill a region's pileup tensors from all overlapping QC-pass reads
    (the Profile::fill_data_into_freq_vec equivalent, util.rs:621-949).

    Dispatches to the C++ decoder when available; the numpy path is the
    reference implementation and the fallback."""
    start0 = region.start - 1
    if start0 >= ref_seq.shape[0]:
        # htslib fetch errors (→ reference panic) when beg is past the
        # contig end; surface it as a clear error instead of a shape crash
        raise ValueError(
            f"region {region} starts beyond the end of {region.chr} "
            f"({ref_seq.shape[0]} bp)")
    ref_window = ref_seq[start0:region.end - 1].copy()
    if ref_window.shape[0] < region.end - region.start:
        # htslib clamps a fetch end past the contig end; mirror that so the
        # pileup tensors stay consistent with the reference window
        from dataclasses import replace as _dc_replace
        region = _dc_replace(region, end=region.start + ref_window.shape[0])
    acc = _empty_tensors(region, ref_window)
    # The reference passes its 1-based Region coords straight into
    # rust-htslib fetch, which interprets them as 0-based half-open
    # (util.rs:637), i.e. the fetch window is shifted +1 relative to the
    # pileup window [start-1, end-1). Reads covering ONLY the first pileup
    # column are therefore missed — replicated here: keep reads with
    # pos < region.end and reference_end() > region.start (both 0-based).
    lo, hi, omask = bam.overlap_range(region.chr, region.start, region.end)
    if lo == hi:
        return acc
    qm = (qc_mask[lo:hi] if qc_mask is not None
          else bam.qc_pass(cfg.min_mapq, cfg.min_read_length, cfg.divergence)[lo:hi])
    eligible = (lo + np.nonzero(omask & qm)[0]).tolist()

    if use_native and eligible:
        from .. import native
        nlib = native.lib()
        if nlib is not None:
            _native_pileup_fill(nlib, bam, eligible, acc, start0, cfg)
            return acc
    for i in eligible:
        add_read(acc, bam.read(i), cfg)
    return acc


def _native_pileup_fill(nlib, bam: BamFile, eligible: List[int],
                        acc: PileupTensors, start0: int,
                        cfg: CallerConfig) -> None:
    import ctypes
    u8p = ctypes.POINTER(ctypes.c_uint8)
    data = np.frombuffer(bam._data, dtype=np.uint8)
    idx = np.asarray(eligible, dtype=np.int64)
    rec_off = bam.rec_off[idx].astype(np.int64)
    rec_end = bam.rec_end[idx].astype(np.int64)
    as_ptr = lambda a, t: a.ctypes.data_as(t)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    args = (
        as_ptr(data, u8p), as_ptr(rec_off, i64p), as_ptr(rec_end, i64p),
        len(eligible), start0, acc.length, as_ptr(acc.ref_base, u8p),
        1 if cfg.is_ont else 0, cfg.distance_to_read_end,
        cfg.polya_tail_length, cfg.min_baseq,
        as_ptr(LOG10_ERR, f64p), as_ptr(LOG10_1MERR, f64p),
        as_ptr(acc.cnt, i32p), as_ptr(acc.n_intron, i32p),
        as_ptr(acc.n_del, i32p), as_ptr(acc.n_ins, i32p),
        as_ptr(acc.fwd, i32p), as_ptr(acc.bwd, i32p),
        as_ptr(acc.strands, i32p), as_ptr(acc.ts, i32p),
        as_ptr(acc.s_err, f64p), as_ptr(acc.s_1merr, f64p),
        as_ptr(acc.bq_pass, i32p))
    # chunk-parallel fill when the read count justifies it: 16 fixed chunks
    # reduced in order — identical result for any thread count, ~1 ulp f64
    # reassociation vs the serial read-order accumulation (the spec path)
    nt = max(1, cfg.threads)
    if (nt > 1 and len(eligible) >= PILEUP_MT_MIN
            and hasattr(nlib, "pileup_fill_mt")):
        rc = nlib.pileup_fill_mt(*args, nt)
    else:
        rc = nlib.pileup_fill(*args)
    if rc != 0:
        raise RuntimeError(f"native pileup_fill failed: rc={rc}")
