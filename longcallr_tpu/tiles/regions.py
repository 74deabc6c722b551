"""Region discovery: depth-scan "isolated regions" over each contig.

Faithful re-implementation of the reference depth scanner
(``longcallR/src/util.rs:236-332`` find_isolated_regions_with_depth and
``util.rs:558-602`` extract_isolated_regions_parallel) with vectorised numpy
depth accumulation instead of a per-base Rust loop. Regions are the unit of
data parallelism in the pipeline — each becomes an independent work item
sharded across hosts/chips.

Exact semantics replicated (needed for output parity):
  * region bounds are (run_start+1, run_end+2): 1-based inclusive start,
    exclusive end (util.rs:300-305);
  * single-column depth runs are NOT emitted (``region_end > region_start``);
  * ``max_coverage`` is a running maximum that resets only when a region is
    emitted, so skipped single-column runs and truncation-break columns fold
    their depth into the next emitted region (util.rs:290-318).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import CallerConfig
from ..io.bam import BamFile, FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED


@dataclass
class Region:
    """Genomic work unit. start is 1-based inclusive; end 1-based exclusive
    (mirrors reference ``util.rs:21-69``)."""

    chr: str
    start: int
    end: int
    max_coverage: Optional[int] = None
    gene_id: Optional[str] = None

    def __str__(self) -> str:
        return f"{self.chr}:{self.start}-{self.end}"

    @property
    def length(self) -> int:
        return self.end - self.start

    @staticmethod
    def parse(region: str) -> "Region":
        """Parse "chr:start-end" (util.rs:35-65)."""
        if ":" not in region:
            return Region(chr=region, start=0, end=0, max_coverage=0)
        chrom, pos = region.split(":", 1)
        s, e = pos.split("-", 1)
        start, end = int(s), int(e)
        if start > end:
            raise ValueError(f"region format error: {region}")
        return Region(chr=chrom, start=start, end=end, max_coverage=0)


def read_qc_mask(bam: BamFile, cfg: CallerConfig) -> np.ndarray:
    """Vectorised read QC shared by every BAM pass of the reference
    (util.rs:652-668, fragment.rs:32-49): mapq, read length, flags, and the
    ``de`` (gap-compressed divergence) aux tag."""
    return bam.qc_pass(cfg.min_mapq, cfg.min_read_length, cfg.divergence)


def find_isolated_regions_with_depth(
    bam: BamFile,
    chrom: str,
    ref_len: int,
    cfg: CallerConfig,
    qc_mask: Optional[np.ndarray] = None,
) -> List[Region]:
    """Depth-scan one contig into isolated regions (util.rs:236-332).

    Implemented as an event sweep over read start/end breakpoints instead of
    the reference's O(contig_length) per-base vector — exact same region
    boundaries, single-column-run skipping, and running-max-coverage carry
    semantics, but O(reads·log reads) and no contig-sized allocations (large
    fresh mappings are pathologically slow on this host; see
    utils/malloc_tune.py).
    """
    lo, hi = bam.contig_record_range(chrom)
    if lo == hi:
        return []
    if qc_mask is None:
        qc_mask = read_qc_mask(bam, cfg)
    sel = qc_mask[lo:hi] & (bam.pos[lo:hi] < ref_len)
    s_arr = bam.pos[lo:hi][sel]
    e_arr = np.minimum(bam.ref_end[lo:hi][sel], ref_len)
    if s_arr.size == 0:
        return []
    # breakpoints where depth changes, bracketed by contig bounds
    bps = np.unique(np.concatenate([s_arr, e_arr, [0, ref_len]]))
    # depth on [bps[j], bps[j+1]) = #starts <= bps[j] - #ends <= bps[j]
    depth = (np.searchsorted(np.sort(s_arr), bps[:-1], side="right")
             - np.searchsorted(np.sort(e_arr), bps[:-1], side="right"))
    seg_s = bps[:-1]
    seg_e = bps[1:]

    trunc = cfg.truncation
    tcov = cfg.truncation_coverage
    regions: List[Region] = []
    carry = 0            # running max_coverage since last reset
    run_s = -1           # current keep-run start column
    run_e = -1           # current keep-run last column

    def flush_break(d_break: int, break_len: int) -> None:
        """Process entering a break interval of depth d_break (first column
        updates the running max before the emit check, util.rs:290-296)."""
        nonlocal carry, run_s, run_e
        carry = max(carry, d_break)
        if run_e > run_s and run_s >= 0:
            regions.append(Region(chr=chrom, start=run_s + 1, end=run_e + 2,
                                  max_coverage=carry))
            carry = 0
            if break_len > 1:
                carry = d_break  # remaining break columns update max again
        run_s = -1
        run_e = -1

    for j in range(seg_s.shape[0]):
        d = int(depth[j])
        s, e = int(seg_s[j]), int(seg_e[j])
        if s >= e:
            continue
        is_break = d == 0 or (trunc and d > tcov)
        if is_break:
            flush_break(d, e - s)
        else:
            carry = max(carry, d)
            if run_s == -1:
                run_s = s
            run_e = e - 1
    # tail: contig ended inside a keep run (no trailing break column)
    if run_s >= 0 and run_e > run_s:
        regions.append(Region(chr=chrom, start=run_s + 1, end=run_e + 2,
                              max_coverage=carry))
    return regions


def extract_isolated_regions_parallel(
    bam: BamFile,
    contig_lengths: Sequence[Tuple[str, int]],
    cfg: CallerConfig,
    contigs: Optional[Sequence[str]] = None,
) -> List[Region]:
    """All-contig region discovery (util.rs:558-602).

    Unlike the reference (one rayon task per contig, unordered Mutex extend),
    results are returned in contig order; downstream VCF emission sorts by
    contig order anyway.
    """
    lengths = dict(contig_lengths)
    names = list(contigs) if contigs is not None else [c for c, _ in contig_lengths]
    qc_mask = read_qc_mask(bam, cfg)

    def work(ctg: str) -> List[Region]:
        if ctg not in lengths:
            raise KeyError(f"contig {ctg} not in .fai")
        return find_isolated_regions_with_depth(bam, ctg, lengths[ctg], cfg, qc_mask)

    if cfg.threads > 1 and len(names) > 1:
        with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
            per_contig = list(ex.map(work, names))
    else:
        per_contig = [work(c) for c in names]
    out: List[Region] = []
    for regs in per_contig:
        out.extend(regs)
    return out
