"""Top-level caller: regions → per-region pipeline → VCF + phased BAM.

The run orchestration of ``longcallR/src/thread.rs:17-362``, with the rayon
thread pool replaced by a thread pool over regions (host I/O + kernel
dispatch; the accelerator executes the batched math) and the nondeterministic
Mutex-queue merges replaced by deterministic (contig, start)-ordered merges.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import CallerConfig
from ..io.bam import BamFile, BamWriter, write_tagged_records
from ..io.fasta import FastaFile
from ..io.vcf import load_input_candidates, write_vcf_header
from ..tiles.regions import Region, extract_isolated_regions_parallel
from .annotation import intersect_gene_regions, parse_annotation
from .engine import RegionResult, finalize_region, prepare_region, process_region

log = logging.getLogger("longcallr_tpu")


def _ambient_jax_placement(fn):
    """Re-enter the calling thread's jax.default_device override inside fn.

    jax config contexts are THREAD-LOCAL: JAX work dispatched from a worker
    thread (the wave prepare/phase pools, the pooled per-region map) would
    otherwise silently ignore an enclosing ``jax.default_device(...)`` —
    e.g. bench.py's CPU comparison leg — and land on the process default
    backend. Captured once on the orchestrating thread at wrap time and
    re-entered inside each worker task. No-op (fn unchanged) when no
    override is active or jax isn't importable yet.
    """
    try:
        import jax
        dev = jax.config.jax_default_device
    except Exception:
        return fn
    if dev is None:
        return fn

    def run_on_ambient(*a, **kw):
        with jax.default_device(dev):
            return fn(*a, **kw)
    return run_on_ambient


@dataclass
class CallerOutputs:
    vcf_path: str
    phased_bam_path: Optional[str]
    n_regions: int
    n_records: int
    n_reads_tagged: int
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    # observability counters (SURVEY.md §5): phased het sites, reads with a
    # haplotype assignment, total fragments/candidates processed
    n_phased_sites: int = 0
    n_assigned_reads: int = 0
    n_fragments: int = 0
    n_candidates: int = 0
    # accelerator-scale phase problems that landed on the host CPU backend
    # because no accelerator exists (utils/device.py warns once; nonzero here
    # means the run's deep path was silently ~100x degraded)
    n_degraded_placements: int = 0


class _ResidentWriteOverlap:
    """Ordered background phased-BAM writer for the batched resident path.

    Byte-exact overlap of the reference's serial third pass
    (thread.rs:307-361): the final output of that pass for a region's
    records depends only on the first-wins merged assignment/phase-set maps
    *restricted to that region's record qnames*. Region W (in the VCF's
    sorted write order) can therefore be deflated as soon as

      (a) every sorted region < F has its maps merged first-wins in sorted
          order (exactly the serial pass's merge order), with W < F, and
      (b) every record qname in W either already holds BOTH merged values
          (final — no later region can override a first-wins entry) or
          provably cannot receive one from any region >= F.

    Condition (b) uses a per-qname upper bound on the last contributing
    region: map keys are subsets of the region's overlap_range fetch
    (phasing/fragments.py::get_fragments), so a read whose span ends before
    every later region's start can never contribute again. Regions that
    fail (b) queue until the frontier passes their bound; with unique
    qnames (the long-read norm) nothing ever queues and each wave's records
    deflate under the next wave's compute. LONGCALLR_RESIDENT_WRITE_OVERLAP=0
    restores the strictly serial end-of-run write.
    """

    def __init__(self, bam: BamFile, regions: List[Region],
                 contig_lengths, path: str, cfg: CallerConfig):
        import threading
        self._bam = bam
        self._path = path
        order = {c: i for i, (c, _) in enumerate(contig_lengths)}
        n = len(regions)
        # identical permutation to run()'s results_sorted (stable sort,
        # same key) so records land in the same file order
        self._perm = sorted(range(n), key=lambda i: (
            order.get(regions[i].chr, 1 << 30), regions[i].start))
        self._sorted_of_list = {li: si for si, li in enumerate(self._perm)}
        self._regions = [regions[i] for i in self._perm]
        self._writer = BamWriter(path, bam.references, bam.lengths,
                                 header_text=bam.header_text,
                                 level=cfg.bam_compression_level,
                                 threads=max(1, cfg.threads))
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()
        self._done: Dict[int, tuple] = {}      # sorted idx → (asg, ps) maps
        self._asg: Dict[str, int] = {}
        self._ps: Dict[str, int] = {}
        self._F = 0           # merge frontier: sorted[0..F) merged
        self._W = 0           # write pointer: sorted[0..W) written
        self._n_tagged = 0
        self._bg_seconds = 0.0
        self._futs = [self._pool.submit(self._prepass)]

    def _prepass(self) -> None:
        """Per-region kept record indices/qnames (the exact write filter)
        and the per-qname last-contributing-region bound. Runs as the
        writer thread's first job, overlapped with the first wave."""
        t0 = time.monotonic()
        bam = self._bam
        from ..io.bam import tagged_record_indices
        n = len(self._regions)
        self._ridxs: List[List[int]] = [[] for _ in range(n)]
        self._keptq: List[List[str]] = [[] for _ in range(n)]
        cb: Dict[str, int] = {}
        by_contig: Dict[str, List[int]] = {}
        for si, reg in enumerate(self._regions):
            by_contig.setdefault(reg.chr, []).append(si)
        for chrom, sidxs in by_contig.items():
            lo, hi = bam.contig_record_range(chrom)
            if lo == hi:
                continue
            qn = bam.qnames_at(np.arange(lo, hi))
            # contribution bound: a record can reach region si's fetch only
            # if that region starts before the record's span end (+2 slop
            # over the replicated off-by-one fetch quirks). Regions of one
            # contig are contiguous in sorted order and ascending by start.
            starts = np.array([self._regions[si].start for si in sidxs],
                              dtype=np.int64)
            # ascending within a contig (discovery order survives the
            # stable sort even when unknown contigs share a sort key);
            # sidxs need not be contiguous, so index through it
            assert (np.diff(starts) >= 0).all()
            wpos = np.searchsorted(starts, bam.ref_end[lo:hi] + 2,
                                   side="left") - 1
            for k in range(hi - lo):
                w = int(wpos[k])
                if w >= 0:
                    q = qn[k]
                    si = sidxs[w]
                    if cb.get(q, -1) < si:
                        cb[q] = si
            for si in sidxs:
                reg = self._regions[si]
                ridxs = tagged_record_indices(bam, chrom, reg.start, reg.end)
                self._ridxs[si] = ridxs.tolist()
                self._keptq[si] = [qn[int(i) - lo] for i in ridxs]
        self._cb = cb
        self._bg_seconds += time.monotonic() - t0

    def wave_done(self, pairs) -> None:
        """Main thread: a wave's (list_index, RegionResult) pairs are final."""
        with self._lock:
            for li, res in pairs:
                self._done[self._sorted_of_list[li]] = (
                    res.read_assignments, res.phase_sets)
        self._futs.append(self._pool.submit(self._advance))

    def _advance(self) -> None:
        t0 = time.monotonic()
        with self._lock:
            done = dict(self._done)
        n = len(self._regions)
        while self._F < n and self._F in done:
            asg, ps = done[self._F]
            for k, v in asg.items():
                self._asg.setdefault(k, v)
            for k, v in ps.items():
                self._ps.setdefault(k, v)
            self._F += 1
        while self._W < self._F and self._safe(self._W):
            ridxs = self._ridxs[self._W]
            if ridxs:
                self._n_tagged += write_tagged_records(
                    self._bam, ridxs, self._asg, self._ps, self._writer)
            self._W += 1
        self._bg_seconds += time.monotonic() - t0

    def _safe(self, w: int) -> bool:
        if self._F >= len(self._regions):
            return True       # everything merged: all values final
        asg, ps, cb, F = self._asg, self._ps, self._cb, self._F
        for q in self._keptq[w]:
            if cb.get(q, -1) >= F and not (q in asg and q in ps):
                return False  # a region >= F could still contribute q
        return True

    def finish(self) -> Tuple[int, float]:
        """Drain the queue, close the writer. Returns (n_tagged,
        background_seconds). Must be called after every region's
        wave_done."""
        self._futs.append(self._pool.submit(self._advance))
        err = None
        for f in self._futs:
            try:
                f.result()
            except BaseException as e:   # close the file either way
                err = err or e
        self._pool.shutdown(wait=True)
        if err is None and self._W != len(self._regions):
            err = RuntimeError(
                f"resident write overlap stalled at {self._W}/"
                f"{len(self._regions)} regions (merged {self._F})")
        self._writer.close()
        if err is not None:
            raise err
        return self._n_tagged, self._bg_seconds

    def abort(self) -> None:
        """Pipeline failed: stop, close, and remove the partial file (the
        serial path would have produced no BAM at all)."""
        try:
            self._pool.shutdown(wait=True, cancel_futures=True)
        finally:
            try:
                self._writer.close()
            except BaseException:
                pass
            try:
                os.unlink(self._path)
            except OSError:
                pass


def build_regions(bam: BamFile, fasta: FastaFile, cfg: CallerConfig,
                  input_region: Optional[str] = None,
                  contigs: Optional[Sequence[str]] = None,
                  anno_path: Optional[str] = None
                  ) -> Tuple[List[Region], Dict[str, List[Tuple[int, int]]]]:
    """main.rs:187-226."""
    if input_region is not None:
        regions = [Region.parse(input_region)]
    else:
        regions = extract_isolated_regions_parallel(
            bam, fasta.contig_lengths, cfg, contigs=contigs)
    gene_regions: Dict[str, List[Region]] = {}
    exon_regions: Dict[str, List[Tuple[int, int]]] = {}
    if anno_path:
        gene_regions, exon_regions = parse_annotation(anno_path)
    if cfg.exon_only:
        if not anno_path:
            raise ValueError("exon_only is set, but annotation file is not provided")
        regions = intersect_gene_regions(regions, gene_regions, merge=True)
    return regions, exon_regions


def run(bam_path: str, ref_path: str, output_prefix: str, cfg: CallerConfig,
        input_vcf: Optional[str] = None, input_region: Optional[str] = None,
        contigs: Optional[Sequence[str]] = None,
        anno_path: Optional[str] = None,
        resume: bool = False, batched: Optional[bool] = False,
        mesh=None) -> CallerOutputs:
    """``resume=True`` keeps a <prefix>.regions.ckpt JSONL of completed
    regions and skips them on restart (region-granular recovery; the
    reference restarts from scratch — SURVEY.md §5).

    ``batched=None`` resolves to the batched driver when there is more
    than one region (its per-wave dispatch amortisation only pays off
    then) and the per-region loop otherwise."""
    t0 = time.monotonic()
    stage: Dict[str, float] = {}
    from ..utils import device as _device
    degraded0 = _device.DEGRADED_PLACEMENTS
    # -r chr:start-end + a .bai beside the BAM → BAI-windowed load: only the
    # BGZF blocks covering the window are read (io/bam.py::_load_window)
    window = None
    if input_region is not None:
        r = Region.parse(input_region)
        if r.start < r.end:   # bare-contig regions load the whole stream
            # ±1 widening covers the replicated fetch off-by-one quirk;
            # overlap_range() does the exact filtering afterwards
            window = (r.chr, max(0, r.start - 1), r.end)
    bam = BamFile(bam_path, threads=max(1, cfg.threads), region=window)
    fasta = FastaFile(ref_path)
    stage["load"] = time.monotonic() - t0

    t1 = time.monotonic()
    regions, exon_regions = build_regions(bam, fasta, cfg, input_region,
                                          contigs, anno_path)
    stage["regions"] = time.monotonic() - t1
    log.info("discovered %d regions", len(regions))

    input_candidates = (load_input_candidates(input_vcf)
                        if input_vcf is not None else None)

    t2 = time.monotonic()
    from .resume import RegionCheckpoint, config_key
    ckpt = RegionCheckpoint(output_prefix + ".regions.ckpt" if resume else None,
                            key=config_key(cfg, input_vcf, anno_path))
    if ckpt.n_done:
        log.info("resume: %d regions already completed", ckpt.n_done)

    # one region per pool worker, single-threaded inside (the rayon layout;
    # see _run_batched)
    cfg_task = (cfg.replace(threads=1)
                if cfg.threads > 1 and len(regions) > 1 else cfg)

    def work(reg: Region) -> RegionResult:
        done = ckpt.get(reg)
        if done is not None:
            return done
        ref_seq = fasta.fetch(reg.chr)
        exon_mask = None
        if cfg.exon_only and reg.gene_id is not None:
            exon_mask = _exon_mask_for(reg, exon_regions)
            if exon_mask is None:
                return RegionResult(reg, [], {}, {}, 0, 0)
        res = process_region(bam, reg, ref_seq, cfg_task,
                             input_candidates=input_candidates,
                             exon_mask=exon_mask)
        if res.n_fragments > 0:
            log.info("region %s: %d fragments, %d candidates",
                     reg, res.n_fragments, res.n_candidates)
        ckpt.put(res)
        return res

    # warm the per-contig reference cache serially to avoid duplicate loads
    for chrom in {r.chr for r in regions}:
        fasta.fetch(chrom)
    if batched is None:
        batched = len(regions) > 1
    # overlapped phased-BAM write: each wave's records deflate on an
    # ordered writer thread under the next wave's compute (byte-identical;
    # see _ResidentWriteOverlap)
    ov = None
    if (batched and not cfg.no_bam_output and len(regions) > 0
            and os.environ.get("LONGCALLR_RESIDENT_WRITE_OVERLAP", "1") != "0"):
        ov = _ResidentWriteOverlap(bam, regions, fasta.contig_lengths,
                                   output_prefix + ".phased.bam", cfg)
    # everything from the region pipeline through ov.finish() aborts the
    # background writer on failure (stops the pool, closes the fd, removes
    # the partial .phased.bam — the serial path would have produced none);
    # after finish() returns the file is complete and must NOT be unlinked
    try:
        if batched:
            results = _run_batched(bam, fasta, regions, cfg, input_candidates,
                                   exon_regions, ckpt, mesh,
                                   on_wave=(ov.wave_done if ov else None))
        elif cfg.threads > 1 and len(regions) > 1:
            with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
                results = list(ex.map(_ambient_jax_placement(work), regions))
        else:
            results = [work(r) for r in regions]
        ckpt.close()
        stage["regions_pipeline"] = time.monotonic() - t2

        # --- VCF (deterministic contig order, then region order) ---
        t3 = time.monotonic()
        order = {c: i for i, (c, _) in enumerate(fasta.contig_lengths)}
        results_sorted = sorted(
            zip(regions, results),
            key=lambda t: (order.get(t[0].chr, 1 << 30), t[0].start))
        vcf_path = output_prefix + ".vcf"
        n_records = 0
        n_phased = 0
        with open(vcf_path, "w") as vf:
            write_vcf_header(vf, fasta.contig_lengths)
            for _, res in results_sorted:
                for line in res.vcf_lines:
                    vf.write(line + "\n")
                    n_records += 1
                    gt = line.split("\t")[9].split(":", 1)[0]
                    if gt in ("0|1", "1|0"):
                        n_phased += 1
        stage["vcf"] = time.monotonic() - t3

        # --- phased BAM (thread.rs:307-361) ---
        phased_bam_path = None
        n_tagged = 0
        if ov is not None:
            t4 = time.monotonic()
            n_tagged, bg = ov.finish()
            phased_bam_path = output_prefix + ".phased.bam"
            stage["phased_bam"] = time.monotonic() - t4  # visible drain only
            stage["phased_bam_bg"] = bg                  # overlapped work
    except BaseException:
        if ov is not None:
            ov.abort()
        raise
    if ov is None and not cfg.no_bam_output:
        t4 = time.monotonic()
        read_assignments: Dict[str, int] = {}
        read_phasesets: Dict[str, int] = {}
        for _, res in results_sorted:  # first-wins merges (thread.rs:309-325)
            for k, v in res.read_assignments.items():
                read_assignments.setdefault(k, v)
            for k, v in res.phase_sets.items():
                read_phasesets.setdefault(k, v)
        phased_bam_path = output_prefix + ".phased.bam"
        with BamWriter(phased_bam_path, bam.references, bam.lengths,
                       header_text=bam.header_text,
                       level=cfg.bam_compression_level,
                       threads=max(1, cfg.threads)) as w:
            from ..io.bam import tagged_record_indices
            for reg, _ in results_sorted:
                ridxs = tagged_record_indices(bam, reg.chr, reg.start,
                                              reg.end).tolist()
                n_tagged += write_tagged_records(
                    bam, ridxs, read_assignments, read_phasesets, w)
        stage["phased_bam"] = time.monotonic() - t4

    stage["total"] = time.monotonic() - t0
    n_assigned = sum(1 for _, res in results_sorted
                     for v in res.read_assignments.values() if v != 0)
    return CallerOutputs(vcf_path=vcf_path, phased_bam_path=phased_bam_path,
                         n_regions=len(regions), n_records=n_records,
                         n_reads_tagged=n_tagged, stage_seconds=stage,
                         n_phased_sites=n_phased, n_assigned_reads=n_assigned,
                         n_fragments=sum(r.n_fragments for _, r in results_sorted),
                         n_candidates=sum(r.n_candidates for _, r in results_sorted),
                         n_degraded_placements=(_device.DEGRADED_PLACEMENTS
                                                - degraded0))


def run_streaming(bam_path: str, ref_path: str, output_prefix: str,
                  cfg: CallerConfig,
                  contigs: Optional[Sequence[str]] = None,
                  input_vcf: Optional[str] = None,
                  anno_path: Optional[str] = None,
                  resume: bool = False,
                  batched: Optional[bool] = None) -> CallerOutputs:
    """Whole-genome mode: one contig resident at a time.

    Requires a ``.bai``: each contig's records are loaded with a BAI-windowed
    read (io/bam.py::_load_window), regions are discovered and processed for
    that contig, its VCF lines and phased records are written out, and the
    window + reference contig are released before the next one. Peak memory
    is one contig's reads + reference instead of the whole BAM (the
    reference binary holds rust-htslib windows per rayon task but keeps the
    whole run's outputs in memory; thread.rs:224-361)."""
    import os

    t0 = time.monotonic()
    stage: Dict[str, float] = {}
    from ..utils import device as _device
    degraded0 = _device.DEGRADED_PLACEMENTS
    if not os.path.exists(bam_path + ".bai"):
        raise ValueError(
            f"streaming mode needs a BAM index: {bam_path}.bai not found "
            "(build one with longcallr_tpu.io.bai.build_bai)")
    fasta = FastaFile(ref_path)
    input_candidates = (load_input_candidates(input_vcf)
                        if input_vcf is not None else None)
    gene_regions: Dict[str, List[Region]] = {}
    exon_regions: Dict[str, List[Tuple[int, int]]] = {}
    if anno_path:
        gene_regions, exon_regions = parse_annotation(anno_path)
    if cfg.exon_only and not anno_path:
        raise ValueError("exon_only is set, but annotation file is not provided")
    vcf_path = output_prefix + ".vcf"
    phased_bam_path = (None if cfg.no_bam_output
                       else output_prefix + ".phased.bam")
    from .resume import RegionCheckpoint, config_key
    ckpt = RegionCheckpoint(output_prefix + ".regions.ckpt" if resume else None,
                            key=config_key(cfg, input_vcf, anno_path))
    if ckpt.n_done:
        log.info("resume: %d regions already completed", ckpt.n_done)
    writer = None
    n_regions_total = n_records = n_phased = n_tagged = 0
    n_assigned = n_frag_total = n_cand_total = 0
    from ..io.bam import collect_tagged_bytes, tagged_record_indices
    # one-ahead window prefetch: contig N+1's BAI-windowed load (IO +
    # native inflate, GIL-released) runs under contig N's compute. The
    # loop's steady state is [prefetch N+1] ∥ [compute N] ∥ [deflate N-1];
    # transient memory is one extra window. LONGCALLR_STREAM_PREFETCH=0
    # restores the strictly-one-contig-resident loop.
    todo_contigs = [(c, l) for c, l in fasta.contig_lengths
                    if not contigs or c in contigs]
    prefetch_on = os.environ.get("LONGCALLR_STREAM_PREFETCH", "1") != "0"
    load_pool = ThreadPoolExecutor(max_workers=1) if prefetch_on else None
    # single ordered writer thread: BGZF deflate of contig N's phased
    # records overlaps contig N+1's compute (submissions execute in order,
    # so the byte stream is identical to inline writes). Gated by the same
    # switch as the prefetch: =0 restores the strictly serial loop.
    write_pool = ThreadPoolExecutor(max_workers=1) if prefetch_on else None
    bam_writes: List = []

    def _load_window(chrom: str, clen: int) -> BamFile:
        return BamFile(bam_path, threads=max(1, cfg.threads),
                       region=(chrom, 0, clen))

    in_flight_exc = False
    try:
        with open(vcf_path, "w") as vf:
            write_vcf_header(vf, fasta.contig_lengths)
            nxt = (load_pool.submit(_load_window, *todo_contigs[0])
                   if load_pool and todo_contigs else None)
            for ci, (chrom, clen) in enumerate(todo_contigs):
                _t = time.monotonic()
                if nxt is not None:
                    win = nxt.result()
                    nxt = (load_pool.submit(_load_window, *todo_contigs[ci + 1])
                           if ci + 1 < len(todo_contigs) else None)
                else:
                    win = _load_window(chrom, clen)
                stage["window_load"] = stage.get("window_load", 0.0) + (
                    time.monotonic() - _t)
                if win.n_records == 0:
                    continue
                if writer is None and phased_bam_path:
                    writer = BamWriter(phased_bam_path, win.references,
                                       win.lengths,
                                       header_text=win.header_text,
                                       level=cfg.bam_compression_level,
                                       threads=max(1, cfg.threads))
                _t = time.monotonic()
                regions = extract_isolated_regions_parallel(
                    win, [(chrom, clen)], cfg, contigs=[chrom])
                stage["discovery"] = stage.get("discovery", 0.0) + (
                    time.monotonic() - _t)
                if cfg.exon_only:
                    regions = intersect_gene_regions(regions, gene_regions,
                                                     merge=True)
                n_regions_total += len(regions)
                ref_seq = fasta.fetch(chrom)

                use_batched = (len(regions) > 1 if batched is None
                               else batched)
                if use_batched and len(regions) > 0:
                    # per-contig batched pipeline (same driver as run())
                    results = _run_batched(win, fasta, regions, cfg,
                                           input_candidates, exon_regions,
                                           ckpt, None)
                else:
                    cfg_task = (cfg.replace(threads=1)
                                if cfg.threads > 1 and len(regions) > 1
                                else cfg)

                    def work(reg: Region) -> RegionResult:
                        done = ckpt.get(reg)
                        if done is not None:
                            return done
                        exon_mask = None
                        if cfg.exon_only and reg.gene_id is not None:
                            exon_mask = _exon_mask_for(reg, exon_regions)
                            if exon_mask is None:
                                return RegionResult(reg, [], {}, {}, 0, 0)
                        res = process_region(win, reg, ref_seq, cfg_task,
                                             input_candidates=input_candidates,
                                             exon_mask=exon_mask)
                        ckpt.put(res)
                        return res

                    if cfg.threads > 1 and len(regions) > 1:
                        with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
                            results = list(ex.map(_ambient_jax_placement(work),
                                                  regions))
                    else:
                        results = [work(r) for r in regions]

                for res in results:
                    n_frag_total += res.n_fragments
                    n_cand_total += res.n_candidates
                    n_assigned += sum(1 for v in
                                      res.read_assignments.values() if v != 0)
                    for line in res.vcf_lines:
                        vf.write(line + "\n")
                        n_records += 1
                        gt = line.split("\t")[9].split(":", 1)[0]
                        if gt in ("0|1", "1|0"):
                            n_phased += 1
                if writer is not None:
                    read_assignments: Dict[str, int] = {}
                    read_phasesets: Dict[str, int] = {}
                    for res in results:
                        for k, v in res.read_assignments.items():
                            read_assignments.setdefault(k, v)
                        for k, v in res.phase_sets.items():
                            read_phasesets.setdefault(k, v)
                    _t = time.monotonic()
                    if write_pool is not None:
                        # backpressure: at most ONE contig's payloads
                        # outstanding (the previous contig's deflate has
                        # normally finished under this contig's compute) —
                        # keeps the documented one-extra-contig memory
                        # contract when deflate is slower than compute
                        for f in bam_writes:
                            f.result()
                        bam_writes.clear()
                    for reg in regions:
                        ridxs = tagged_record_indices(
                            win, reg.chr, reg.start, reg.end).tolist()
                        # assemble synchronously (cheap, owns its bytes),
                        # deflate+write on the single ordered writer thread
                        # so the BGZF compression of contig N overlaps
                        # contig N+1's window load / pipeline — the window
                        # is still evicted right below (memory contract
                        # unchanged up to one contig's payload bytes)
                        payload, cnt = collect_tagged_bytes(
                            win, ridxs, read_assignments, read_phasesets)
                        n_tagged += cnt
                        if payload and write_pool is not None:
                            bam_writes.append(
                                write_pool.submit(writer._w.write, payload))
                        elif payload:
                            writer._w.write(payload)
                    stage["bam_emit"] = stage.get("bam_emit", 0.0) + (
                        time.monotonic() - _t)
                del win
                fasta.evict(chrom)
                # return the evicted contig's freed heap to the OS: tune()
                # disables glibc auto-trim to keep freed blocks warm, which
                # is right WITHIN a contig but accumulates every contig's
                # working set into the peak RSS across a whole-genome run
                # (measured: 9.3 GB peak over 24 contigs / 712 MB BAM
                # without the trim; refaulting a trimmed set runs at
                # ~2 GB/s, so the per-contig cost is tens of ms)
                from ..utils import malloc_tune as _mt
                _mt.trim()
    except BaseException:
        in_flight_exc = True
        raise
    finally:
        ckpt.close()
        if load_pool is not None:
            load_pool.shutdown(wait=True)
        _t = time.monotonic()
        drain_err = None
        for f in bam_writes:
            try:
                f.result()      # drain (and surface) pending deflate work
            except BaseException as e:   # keep closing; re-raise after
                drain_err = drain_err or e
        if write_pool is not None:
            write_pool.shutdown()
        if writer is not None:
            writer.close()      # always append the BGZF EOF block
        if bam_writes:
            stage["bam_write_drain"] = time.monotonic() - _t
        if drain_err is not None and not in_flight_exc:
            # surface a failed background write, but never mask an
            # exception already propagating out of the contig loop
            raise drain_err
    if writer is None:
        phased_bam_path = None      # no records anywhere → no BAM written
    stage["total"] = time.monotonic() - t0
    return CallerOutputs(vcf_path=vcf_path, phased_bam_path=phased_bam_path,
                         n_regions=n_regions_total, n_records=n_records,
                         n_reads_tagged=n_tagged, stage_seconds=stage,
                         n_phased_sites=n_phased, n_assigned_reads=n_assigned,
                         n_fragments=n_frag_total, n_candidates=n_cand_total,
                         n_degraded_placements=(_device.DEGRADED_PLACEMENTS
                                                - degraded0))


def _exon_mask_for(reg: Region, exon_regions: Dict[str, List[Tuple[int, int]]]):
    """Exon coverage mask over the region window (thread.rs:80-92 +
    candidate.rs:80-89). Returns None when no exon covers the region's genes."""
    invs: List[Tuple[int, int]] = []
    for gene_id in (reg.gene_id or "").split(","):
        invs.extend(exon_regions.get(gene_id, []))
    if not invs:
        return None
    P = reg.end - reg.start
    mask = np.zeros(P + 1, dtype=np.int32)
    for s, e in invs:  # 1-based [s, e) intervals
        lo = max(0, s - reg.start)
        hi = min(P, e - reg.start)
        if lo < hi:
            mask[lo] += 1
            mask[hi] -= 1
    return np.cumsum(mask[:-1]) > 0


def _run_batched(bam, fasta, regions, cfg, input_candidates, exon_regions,
                 ckpt, mesh, on_wave=None):
    """Three-stage batched pipeline: threaded host prepare → bucketed
    device phasing (phasing/batch_driver.py) → threaded host finalize.

    ``on_wave``: called with a list of (region_index, RegionResult) pairs
    as each wave finalizes (and once up front for checkpointed/skipped
    regions) — the overlapped phased-BAM writer's feed."""
    from ..phasing.batch_driver import phase_regions_batched

    results: List[Optional[RegionResult]] = [None] * len(regions)
    prepared: List[Optional[tuple]] = [None] * len(regions)

    pooled = cfg.threads > 1 and len(regions) > 1
    # one region per pool worker, single-threaded inside (the rayon layout):
    # the native decode releases the GIL, so the pool parallelises it without
    # nested thread oversubscription
    cfg_task = cfg.replace(threads=1) if pooled else cfg

    # triage: checkpointed / exon-skipped regions drop out up front
    todo_prep: List[Tuple[int, Optional[np.ndarray]]] = []
    for i, reg in enumerate(regions):
        done = ckpt.get(reg)
        if done is not None:
            results[i] = done
            continue
        exon_mask = None
        if cfg.exon_only and reg.gene_id is not None:
            exon_mask = _exon_mask_for(reg, exon_regions)
            if exon_mask is None:
                results[i] = RegionResult(reg, [], {}, {}, 0, 0)
                continue
        todo_prep.append((i, exon_mask))
    if on_wave is not None:
        preset_pairs = [(i, r) for i, r in enumerate(results) if r is not None]
        if preset_pairs:
            on_wave(preset_pairs)

    # Waves bounded by the candidate kernel's column budget AND a host-work
    # budget (estimated pileup cells = columns × discovered coverage): deep
    # loci split into multiple waves so the double-buffered prepare below has
    # something to overlap. Each wave runs end to end — pooled pileup → one
    # batched candidate dispatch → pooled fragments → bucketed phasing →
    # finalize + checkpoint — so at most TWO waves' pileup/fragment tensors
    # stay resident (one phasing + one preparing; the --stream memory
    # contract) and --resume loses at most one wave on a crash. Wave
    # composition cannot change results: bucketing is composition-independent
    # (per-region seed streams, phasing/batch_driver.py).
    from ..ops.candidates import CAND_BATCH_COLS, select_candidates_batched
    from .engine import (stage_add, import_external_candidates,
                         prepare_region_fragments, prepare_region_pileup)
    wave_cells = int(os.environ.get("LONGCALLR_WAVE_CELLS", str(32 * 1024 * 1024)))
    # regions with at least this many fragment-matrix cells finalize on a
    # thread pool (see the deep-wave finalize fan-out below). Default OFF
    # (0): on this 4-core host OpenBLAS already parallelises the [K,4I]
    # assignment GEMMs internally, so pooling oversubscribes (measured
    # 8.06 s → 8.24 s on the deep CPU leg). The knob exists for many-core
    # deployment hosts, where the single-threaded elementwise fraction of
    # assign dominates and per-region fan-out is the only lever.
    _env = os.environ.get("LONGCALLR_FINALIZE_MT_CELLS", "0")
    try:
        _env_val = int(_env)
    except ValueError:
        raise ValueError(
            f"LONGCALLR_FINALIZE_MT_CELLS must be an integer, got {_env!r}")
    _FINALIZE_MT_CELLS = _env_val if _env_val > 0 else (1 << 62)

    def _pileup_one(item):
        i, _ = item
        reg = regions[i]
        return prepare_region_pileup(bam, reg, fasta.fetch(reg.chr), cfg_task)

    def _cands_one(arg):
        (i, _), pl = arg
        chr_cands = input_candidates.get(regions[i].chr, {})
        return import_external_candidates(pl, fasta.fetch(regions[i].chr),
                                          chr_cands)

    def _frags_one(arg):
        i, cands = arg
        frags, apply_ds = prepare_region_fragments(bam, regions[i], cands,
                                                   cfg_task)
        prepared[i] = (cands, frags, apply_ds)

    def _pmap(fn, items):
        if pooled and len(items) > 1:
            with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
                return list(ex.map(fn, items))
        return [fn(it) for it in items]

    def _cells(idx: int) -> int:
        reg = regions[idx]
        return reg.length * max(1, getattr(reg, "max_coverage", 0) or 0)

    wave_spans: List[List[Tuple[int, Optional[np.ndarray]]]] = []
    w0 = 0
    while w0 < len(todo_prep):
        w1 = w0 + 1
        tot = regions[todo_prep[w0][0]].length
        cells = _cells(todo_prep[w0][0])
        while (w1 < len(todo_prep)
               and tot + regions[todo_prep[w1][0]].length <= CAND_BATCH_COLS
               and cells + _cells(todo_prep[w1][0]) <= wave_cells):
            tot += regions[todo_prep[w1][0]].length
            cells += _cells(todo_prep[w1][0])
            w1 += 1
        wave_spans.append(todo_prep[w0:w1])
        w0 = w1

    def _prepare_wave(wave):
        """Host stages of one wave (pileup → candidates → fragments); fills
        prepared[] and returns (todo, phase_items, phase_index)."""
        pileups = _pmap(_pileup_one, wave)
        _t = time.monotonic()
        if input_candidates is not None:
            cands_list = _pmap(_cands_one, list(zip(wave, pileups)))
        else:
            cands_list = select_candidates_batched(
                pileups, cfg, [em for _, em in wave])
        stage_add("candidates", time.monotonic() - _t)
        del pileups
        _pmap(_frags_one, [(i, c) for (i, _), c in zip(wave, cands_list)])
        todo = [i for (i, _) in wave if prepared[i] is not None]
        phase_items = []
        phase_index = []
        for i in todo:
            cands, frags, apply_ds = prepared[i]
            if cands.n > 0 and frags.n_frags > 0:
                phase_items.append((frags, cands, regions[i].start, apply_ds))
                phase_index.append(i)
        return todo, phase_items, phase_index

    # Pipelined waves: wave N+1's host prepare runs on one background
    # thread and wave N+1's bucketed phasing is dispatched on a second
    # BEFORE wave N's finalize runs on the main thread, so the device (or
    # the phasing core set) never idles behind the assignment layer.
    # Phases stay strictly serialized on a 1-worker pool and finalize +
    # checkpoint order is unchanged, and bucketing is composition-
    # independent — byte-invariant. Steady state holds at most THREE
    # waves' tensors (one finalizing, one phasing, one preparing; the
    # wave_cells budget bounds each); a crash under --resume loses at most
    # the two unfinalized waves. LONGCALLR_WAVE_OVERLAP=0 restores the
    # strictly serial prepare → phase → finalize loop.
    overlap = (os.environ.get("LONGCALLR_WAVE_OVERLAP", "1") != "0"
               and len(wave_spans) > 1)
    ahead = ThreadPoolExecutor(max_workers=1) if overlap else None
    phase_pool = ThreadPoolExecutor(max_workers=1) if overlap else None

    def _phase_wave(prep):
        todo, phase_items, phase_index = prep
        states = phase_regions_batched(phase_items, cfg, mesh=mesh)
        return todo, phase_index, states

    if overlap:
        # worker threads must see the caller's jax.default_device override
        _prepare_bg = _ambient_jax_placement(_prepare_wave)
        _phase_bg = _ambient_jax_placement(_phase_wave)

    try:
        if overlap:
            first_prep = ahead.submit(_prepare_bg, wave_spans[0]).result()
            next_prep = ahead.submit(_prepare_bg, wave_spans[1])
            phase_fut = phase_pool.submit(_phase_bg, first_prep)
        for w, wave in enumerate(wave_spans):
            if overlap:
                todo, phase_index, states = phase_fut.result()
                if w + 1 < len(wave_spans):
                    prep = next_prep.result()
                    next_prep = (ahead.submit(_prepare_bg, wave_spans[w + 2])
                                 if w + 2 < len(wave_spans) else None)
                    phase_fut = phase_pool.submit(_phase_bg, prep)
            else:
                todo, phase_items, phase_index = _prepare_wave(wave)
                states = phase_regions_batched(phase_items, cfg, mesh=mesh)
            st_by_region = {phase_index[j]: states[j]
                            for j in range(len(phase_index))}

            def _finalize_one(i):
                cands, frags, apply_ds = prepared[i]
                return finalize_region(regions[i], cands, frags,
                                       st_by_region.get(i), cfg, apply_ds)

            # Deep waves fan finalize out over a thread pool: the assignment
            # layer is [K,4I] f64 GEMMs that release the GIL, ~0.2 s/region
            # at 4096x512 (bench deep leg). Small regions stay serial even
            # inside a mixed wave — there the GIL-held numpy dispatch
            # dominates and threads only add contention — so only the big
            # regions are submitted to the pool. Per-region results are
            # independent (own rng stream, own ct/T4 slot — assign.py
            # thread-local cache), so only the ckpt.put order below is
            # order-sensitive.
            big = {i for i in todo
                   if prepared[i][1].n_frags * max(prepared[i][0].n, 1)
                   >= _FINALIZE_MT_CELLS}
            if len(big) >= 2 and cfg.threads > 1:
                with ThreadPoolExecutor(
                        max_workers=min(cfg.threads, len(big))) as fex:
                    futs = {i: fex.submit(_finalize_one, i) for i in todo
                            if i in big}
                    for i in todo:   # checkpoint puts stay in wave order
                        res = futs[i].result() if i in big else _finalize_one(i)
                        ckpt.put(res)
                        results[i] = res
                        prepared[i] = None
            else:
                for i in todo:
                    res = _finalize_one(i)
                    ckpt.put(res)
                    results[i] = res
                    prepared[i] = None
            if on_wave is not None and todo:
                on_wave([(i, results[i]) for i in todo])
    finally:
        if ahead is not None:
            ahead.shutdown(wait=True, cancel_futures=True)
        if phase_pool is not None:
            phase_pool.shutdown(wait=True, cancel_futures=True)
    return results
