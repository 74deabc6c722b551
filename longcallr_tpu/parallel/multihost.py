"""Multi-host execution: region shards per process, gathered merge.

The reference's "distributed backend" is a rayon thread pool in one address
space (thread.rs:52-77). Here a pod-slice run is N JAX processes
(``jax.distributed.initialize`` over the network): every host discovers the same
region list deterministically, takes its shard (size-balanced LPT), runs the
region pipeline against its local BAM copy, and the per-region results —
tiny relative to compute — are gathered to every process with
``process_allgather`` over the device mesh; process 0 retries any regions a
peer failed to deliver (regions are stateless, idempotent work units) and
serialises the VCF and phased BAM in contig order, mirroring the reference's
serial writer (thread.rs:224-361).

Degenerates to the single-process pipeline when ``jax.process_count() == 1``
(real pods only add the ``jax.distributed.initialize`` call). The shard and
serialisation stages are plain functions (``run_local_shard``,
``serialize_outputs``) so the multi-process data path is exercised in
single-process tests by faking the shard split.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from .. import _jaxcfg  # noqa: F401  (x64 before any trace)
import jax
import numpy as np

from ..config import CallerConfig
from ..tiles.regions import Region


def host_gpu_count() -> int:
    """NVIDIA cards visible on this host, as ``nvidia-smi -L`` lists them
    (no JAX backend is initialised, so a pod process can pick its card
    first; /dev/nvidiaN nodes need not match the visible cards). 0 where
    nvidia-smi is absent."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def pod_local_device_ids(process_id: int, n_host_gpus: int,
                         environ=os.environ) -> Optional[List[int]]:
    """The card a pod process opens: one per process, so processes that
    share a host never open each other's cards (a JAX process reserves most
    of a card's memory, and a second one on it runs out). Process p takes
    card p mod (cards per host), which assumes the launcher places the same
    number of consecutive process ids on every host. A launcher that sets
    CUDA_VISIBLE_DEVICES or JAX_LOCAL_DEVICE_IDS has already chosen: None.
    None also on hosts without cards."""
    if "CUDA_VISIBLE_DEVICES" in environ or "JAX_LOCAL_DEVICE_IDS" in environ:
        return None
    if n_host_gpus <= 0:
        return None
    return [process_id % n_host_gpus]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize wrapper (no-op when unconfigured); each
    process opens only its own card (pod_local_device_ids)."""
    if coordinator_address is None and num_processes is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id,
        local_device_ids=pod_local_device_ids(process_id or 0,
                                              host_gpu_count()))


def shard_regions(regions: Sequence[Region], num_processes: int,
                  process_id: int) -> List[int]:
    """Deterministic size-balanced assignment: regions sorted by descending
    work estimate (length × max coverage), dealt to the least-loaded shard
    (LPT). Returns the indices owned by ``process_id``, in original order."""
    est = [(-(r.length * max(1, r.max_coverage or 1)), i)
           for i, r in enumerate(regions)]
    est.sort()
    loads = [0] * num_processes
    owner = [0] * len(regions)
    for negw, i in est:
        p = int(np.argmin(loads))
        owner[i] = p
        loads[p] += -negw
    return [i for i in range(len(regions)) if owner[i] == process_id]


def _encode_results(results: Dict[int, dict]) -> np.ndarray:
    raw = json.dumps(results).encode()
    return np.frombuffer(raw, dtype=np.uint8)


# set when a gather timed out with its thread still blocked in the
# collective; all later collectives in this process would desync
_gather_poisoned = False


def _gather_collective(local: Dict[int, dict]) -> Dict[int, dict]:
    from jax.experimental import multihost_utils

    raw = _encode_results(local)
    n = np.asarray([raw.shape[0]], dtype=np.int64)
    lens = np.asarray(multihost_utils.process_allgather(n)).reshape(-1)
    pad = int(lens.max())
    buf = np.zeros(pad, dtype=np.uint8)
    buf[:raw.shape[0]] = raw
    gathered = np.asarray(multihost_utils.process_allgather(buf))
    merged: Dict[int, dict] = {}
    for p in range(jax.process_count()):
        payload = bytes(gathered[p][: int(lens[p])])
        part = json.loads(payload)
        merged.update({int(k): v for k, v in part.items()})
    return merged


def gather_results(local: Dict[int, dict],
                   timeout_s: Optional[float] = None) -> Dict[int, dict]:
    """All-gather per-region result payloads across processes.

    Payloads are JSON-serialised to uint8 and padded to the global max
    length; with one process this is the identity.

    ``timeout_s`` (or LONGCALLR_GATHER_TIMEOUT seconds, 0 = wait forever)
    bounds the collective: a peer that dies INSIDE the allgather would
    otherwise hang every process. On timeout the local payloads are
    returned — process 0 then re-runs the missing regions serially
    (``serialize_outputs``) so the run still completes, degraded.

    A timed-out gather leaves its daemon thread parked inside
    ``process_allgather``; surviving peers are still inside that collective,
    so ANY later collective in this process would desync with them. The
    gather must therefore be the last collective of the run: after a
    timeout this module poisons itself and subsequent calls fail loudly
    instead of silently corrupting a later collective."""
    global _gather_poisoned
    if jax.process_count() == 1:
        return dict(local)
    if _gather_poisoned:
        raise RuntimeError(
            "gather_results: a previous gather timed out, leaving a thread "
            "blocked inside process_allgather; collectives in this process "
            "are unusable (restart the process to rejoin the pod)")
    import threading

    if timeout_s is None:
        t = float(os.environ.get("LONGCALLR_GATHER_TIMEOUT", "0"))
        timeout_s = t if t > 0 else None
    if timeout_s is None:
        return _gather_collective(local)
    box: dict = {}

    def run():
        try:
            box["merged"] = _gather_collective(local)
        except BaseException as e:     # noqa: BLE001 — re-raised below
            box["exc"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout_s)
    if "merged" in box:
        return box["merged"]
    if "exc" in box:
        # the gather FAILED rather than timed out: surface the real error
        # (the no-timeout path raises the same way) instead of misreporting
        # a timeout and silently re-running every peer's regions. Peers may
        # be parked mid-collective, so still poison later collectives.
        _gather_poisoned = True
        raise box["exc"]
    _gather_poisoned = True
    import logging
    logging.getLogger(__name__).warning(
        "gather_results timed out after %.0fs; continuing with local "
        "results only (missing regions will be retried on process 0)",
        timeout_s)
    return dict(local)


def gather_degraded() -> bool:
    """True when a gather timed out this process (a peer died mid-
    collective). A degraded survivor must NOT run the normal interpreter
    teardown: the distributed client's shutdown barrier blocks on the dead
    peer and ends in an uncatchable LOG(FATAL) (see
    tests/test_parallel.py's harness). Callers that own the process exit
    (the CLI) should flush outputs and ``os._exit`` instead."""
    return _gather_poisoned


def _payload(res) -> dict:
    return dict(vcf_lines=res.vcf_lines,
                read_assignments=res.read_assignments,
                phase_sets=res.phase_sets,
                n_fragments=res.n_fragments,
                n_candidates=res.n_candidates)


def run_local_shard(bam, fasta, regions: Sequence[Region],
                    mine: Sequence[int], cfg: CallerConfig,
                    input_candidates: Optional[dict] = None,
                    exon_regions: Optional[dict] = None,
                    ckpt=None) -> Tuple[Dict[int, dict], List[int]]:
    """Process this host's region shard with the batched device driver.
    Returns (region index → result payload, failed region indices);
    failures are isolated per region, never fatal to the shard.

    Honors the same per-region inputs as the single-process path
    (pipeline/caller.run): external -v candidates, --exon-only masks, and
    an optional RegionCheckpoint for --resume."""
    from ..phasing.batch_driver import phase_regions_batched
    from ..pipeline.engine import RegionResult, finalize_region, prepare_region
    from ..pipeline.caller import _exon_mask_for

    # Accelerator-less pod processes run the same batched path: the shard's
    # buckets are split to CPU_BUCKET_B_CAP inside the batch driver, which
    # bounds the batch-convergence coupling that made one whole-shard B=32
    # bucket ~2x slower than wave-sized dispatches (measured on the
    # 104k-read pod leg; see phasing/batch_driver.py).
    local: Dict[int, dict] = {}
    items, item_idx = [], []
    prepared = {}
    failed: List[int] = []
    for i in mine:
        reg = regions[i]
        done = ckpt.get(reg) if ckpt is not None else None
        if done is not None:
            local[i] = _payload(done)
            continue
        exon_mask = None
        if cfg.exon_only and reg.gene_id is not None:
            exon_mask = _exon_mask_for(reg, exon_regions or {})
            if exon_mask is None:
                empty = RegionResult(reg, [], {}, {}, 0, 0)
                local[i] = _payload(empty)
                if ckpt is not None:
                    ckpt.put(empty)
                continue
        try:
            ref_seq = fasta.fetch(reg.chr)
            cands, frags, apply_ds = prepare_region(
                bam, reg, ref_seq, cfg,
                input_candidates=input_candidates, exon_mask=exon_mask)
        except Exception:
            failed.append(i)
            continue
        prepared[i] = (cands, frags, apply_ds)
        if cands.n > 0 and frags.n_frags > 0:
            items.append((frags, cands, reg.start, apply_ds))
            item_idx.append(i)
    try:
        states = phase_regions_batched(items, cfg)
    except Exception:
        # one region's device-side failure must not kill the shard (the
        # per-region isolation this function promises): fall back to
        # per-region phasing; a region that still fails drops out of
        # `local` and is retried stateless on process 0
        from ..phasing.optimize import phase_region
        states = []
        for j, (frags, cands, start, apply_ds) in enumerate(items):
            try:
                states.append(phase_region(frags, cands, cfg, seed=start,
                                           apply_downsampling=apply_ds))
            except Exception:
                states.append(None)
                i = item_idx[j]
                prepared.pop(i, None)
                failed.append(i)
    st_by = {item_idx[j]: states[j] for j in range(len(item_idx))}
    for i in mine:
        if i not in prepared:
            continue
        cands, frags, apply_ds = prepared[i]
        try:
            res = finalize_region(regions[i], cands, frags, st_by.get(i), cfg,
                                  apply_ds)
        except Exception:
            failed.append(i)
            continue
        local[i] = _payload(res)
        if ckpt is not None:
            ckpt.put(res)
    return local, failed


def serialize_outputs(bam, fasta, regions: Sequence[Region],
                      merged: Dict[int, dict], cfg: CallerConfig,
                      output_prefix: str,
                      input_candidates: Optional[dict] = None,
                      exon_regions: Optional[dict] = None) -> dict:
    """Process-0 output stage: retry regions missing from the gathered
    results (peer crash / local failure — stateless re-run) under the same
    per-region inputs as the shard pass, then write the VCF and phased BAM
    in contig order (thread.rs:224-361)."""
    from ..io.vcf import write_vcf_header
    from ..pipeline.caller import _exon_mask_for
    from ..pipeline.engine import process_region

    missing = [i for i in range(len(regions)) if i not in merged]
    n_retried = len(missing)
    for i in missing:
        try:
            reg = regions[i]
            exon_mask = None
            if cfg.exon_only and reg.gene_id is not None:
                exon_mask = _exon_mask_for(reg, exon_regions or {})
                if exon_mask is None:
                    merged[i] = dict(vcf_lines=[], read_assignments={},
                                     phase_sets={}, n_fragments=0,
                                     n_candidates=0)
                    continue
            res = process_region(bam, reg, fasta.fetch(reg.chr), cfg,
                                 input_candidates=input_candidates,
                                 exon_mask=exon_mask)
            merged[i] = _payload(res)
        except Exception:
            continue  # genuinely poisoned region: skip, keep the run

    order = {c: i for i, (c, _) in enumerate(fasta.contig_lengths)}
    idx_sorted = sorted(range(len(regions)),
                        key=lambda i: (order.get(regions[i].chr, 1 << 30),
                                       regions[i].start))
    vcf_path = output_prefix + ".vcf"
    with open(vcf_path, "w") as vf:
        write_vcf_header(vf, fasta.contig_lengths)
        for i in idx_sorted:
            for line in merged.get(i, {}).get("vcf_lines", []):
                vf.write(line + "\n")

    # phased BAM (thread.rs:307-361): first-wins merges over the gathered
    # per-region assignments, raw record pass-through + appended HP/PS tags
    phased_bam_path = None
    if not cfg.no_bam_output:
        from ..io.bam import BamWriter, tagged_record_indices
        read_assignments: Dict[str, int] = {}
        read_phasesets: Dict[str, int] = {}
        for i in idx_sorted:
            res = merged.get(i, {})
            for k, v in res.get("read_assignments", {}).items():
                read_assignments.setdefault(k, v)
            for k, v in res.get("phase_sets", {}).items():
                read_phasesets.setdefault(k, v)
        phased_bam_path = output_prefix + ".phased.bam"
        with BamWriter(phased_bam_path, bam.references, bam.lengths,
                       header_text=bam.header_text,
                       level=cfg.bam_compression_level,
                       threads=max(1, cfg.threads)) as w:
            from ..io.bam import write_tagged_records
            for i in idx_sorted:
                reg = regions[i]
                ridxs = tagged_record_indices(bam, reg.chr, reg.start,
                                              reg.end).tolist()
                write_tagged_records(bam, ridxs, read_assignments,
                                     read_phasesets, w)
    return {"process": 0, "vcf_path": vcf_path,
            "phased_bam_path": phased_bam_path, "n_regions": len(regions),
            "n_retried": n_retried}


def run_multihost(bam_path: str, ref_path: str, output_prefix: str,
                  cfg: CallerConfig, stream: Optional[bool] = None,
                  **run_kwargs):
    """Pod-slice caller: shard regions across processes, gather, and let
    process 0 write the outputs. Returns CallerOutputs on a single process,
    the serialisation summary on process 0 of a pod, and a shard summary on
    other processes.

    ``stream``: per-contig BAI-windowed shard processing — each process
    keeps one contig of ITS shard resident instead of the whole BAM (the
    pod analog of --stream; outputs identical). Default AUTO: engaged for
    indexed BAMs over LONGCALLR_STREAM_AUTO_MB when no -r is given."""
    import os

    from ..io.bam import BamFile
    from ..io.fasta import FastaFile
    from ..pipeline.caller import build_regions, run

    pid = jax.process_index()
    n_proc = jax.process_count()
    if stream is None:
        auto_mb = float(os.environ.get("LONGCALLR_STREAM_AUTO_MB", "1024"))
        stream = (os.path.exists(bam_path + ".bai")
                  and os.path.getsize(bam_path) > auto_mb * 1e6
                  and not run_kwargs.get("input_region"))
    if n_proc == 1:
        # degenerate 1-process pod: behave exactly like the non-pod CLI —
        # including the --stream request / AUTO above (a 1-process launch
        # over a 100 GB indexed BAM must not go whole-resident)
        if stream:
            from ..pipeline.caller import run_streaming
            return run_streaming(
                bam_path, ref_path, output_prefix, cfg,
                contigs=run_kwargs.get("contigs"),
                input_vcf=run_kwargs.get("input_vcf"),
                anno_path=run_kwargs.get("anno_path"),
                resume=run_kwargs.get("resume", False))
        # same default as the CLI: batched AUTO (on for >1 region)
        run_kwargs.setdefault("batched", None)
        return run(bam_path, ref_path, output_prefix, cfg, **run_kwargs)
    if stream:
        if run_kwargs.get("input_region"):
            raise ValueError("streaming multihost does not take an input "
                             "region (use the resident path for -r runs)")
        return _run_multihost_streaming(bam_path, ref_path, output_prefix,
                                        cfg, pid, n_proc, run_kwargs)

    bam = BamFile(bam_path, threads=max(1, cfg.threads))
    fasta = FastaFile(ref_path)
    regions, exon_regions = build_regions(
        bam, fasta, cfg, run_kwargs.get("input_region"),
        run_kwargs.get("contigs"), run_kwargs.get("anno_path"))
    mine = shard_regions(regions, n_proc, pid)

    input_vcf = run_kwargs.get("input_vcf")
    input_candidates = None
    if input_vcf is not None:
        from ..io.vcf import load_input_candidates
        input_candidates = load_input_candidates(input_vcf)
    ckpt = None
    if run_kwargs.get("resume"):
        # one sidecar per process: peers must not interleave appends
        from ..pipeline.resume import RegionCheckpoint, config_key
        ckpt = RegionCheckpoint(
            f"{output_prefix}.regions.p{pid}.ckpt",
            key=config_key(cfg, input_vcf, run_kwargs.get("anno_path")))

    local, failed = run_local_shard(bam, fasta, regions, mine, cfg,
                                    input_candidates=input_candidates,
                                    exon_regions=exon_regions, ckpt=ckpt)
    merged = gather_results(local)
    if ckpt is not None:
        ckpt.close()
    if pid != 0:
        return {"process": pid, "n_regions_local": len(mine),
                "n_failed_local": len(failed)}
    return serialize_outputs(bam, fasta, regions, merged, cfg, output_prefix,
                             input_candidates=input_candidates,
                             exon_regions=exon_regions)


def _run_multihost_streaming(bam_path: str, ref_path: str,
                             output_prefix: str, cfg: CallerConfig,
                             pid: int, n_proc: int, run_kwargs: dict):
    """Pod + whole-genome: every process discovers the SAME region list
    deterministically one contig window at a time (never holding the whole
    BAM), processes only ITS shard's contigs through BAI windows, gathers,
    and process 0 serialises per contig. Peak memory per process is one
    contig's window (pipeline/caller.run_streaming semantics per shard)."""
    from ..io.bam import BamFile
    from ..io.fasta import FastaFile
    from ..pipeline.annotation import intersect_gene_regions, parse_annotation
    from ..tiles.regions import extract_isolated_regions_parallel

    fasta = FastaFile(ref_path)
    contigs_filter = run_kwargs.get("contigs")
    gene_regions, exon_regions = {}, {}
    anno_path = run_kwargs.get("anno_path")
    if anno_path:
        gene_regions, exon_regions = parse_annotation(anno_path)
    if cfg.exon_only and not anno_path:
        raise ValueError("exon_only is set, but annotation file is not provided")
    input_vcf = run_kwargs.get("input_vcf")
    input_candidates = None
    if input_vcf is not None:
        from ..io.vcf import load_input_candidates
        input_candidates = load_input_candidates(input_vcf)

    # pass 1: deterministic global discovery, one contig resident at a time
    regions: List[Region] = []
    threads = max(1, cfg.threads)
    for chrom, clen in fasta.contig_lengths:
        if contigs_filter and chrom not in contigs_filter:
            continue
        win = BamFile(bam_path, threads=threads, region=(chrom, 0, clen))
        if win.n_records == 0:
            continue
        rs = extract_isolated_regions_parallel(win, [(chrom, clen)], cfg,
                                               contigs=[chrom])
        if cfg.exon_only:
            rs = intersect_gene_regions(rs, gene_regions, merge=True)
        regions.extend(rs)
        del win
        fasta.evict(chrom)

    mine = shard_regions(regions, n_proc, pid)
    ckpt = None
    if run_kwargs.get("resume"):
        from ..pipeline.resume import RegionCheckpoint, config_key
        ckpt = RegionCheckpoint(
            f"{output_prefix}.regions.p{pid}.ckpt",
            key=config_key(cfg, input_vcf, anno_path))

    # pass 2: my shard, contig by contig through BAI windows
    local: Dict[int, dict] = {}
    failed: List[int] = []
    by_contig: Dict[str, List[int]] = {}
    for i in mine:
        by_contig.setdefault(regions[i].chr, []).append(i)
    for chrom in by_contig:
        clen = dict(fasta.contig_lengths)[chrom]
        win = BamFile(bam_path, threads=threads, region=(chrom, 0, clen))
        l, f = run_local_shard(win, fasta, regions, by_contig[chrom], cfg,
                               input_candidates=input_candidates,
                               exon_regions=exon_regions, ckpt=ckpt)
        local.update(l)
        failed.extend(f)
        del win
        fasta.evict(chrom)

    merged = gather_results(local)
    if ckpt is not None:
        ckpt.close()
    if pid != 0:
        return {"process": pid, "n_regions_local": len(mine),
                "n_failed_local": len(failed)}
    return _serialize_outputs_streaming(bam_path, fasta, regions, merged,
                                        cfg, output_prefix,
                                        input_candidates=input_candidates,
                                        exon_regions=exon_regions)


def _serialize_outputs_streaming(bam_path: str, fasta, regions, merged,
                                 cfg: CallerConfig, output_prefix: str,
                                 input_candidates=None, exon_regions=None):
    """Process-0 output stage of the streaming pod: retries and the phased
    BAM pass-through run against per-contig BAI windows (contig order),
    never the whole BAM."""
    from ..io.bam import (BamFile, BamWriter, tagged_record_indices,
                          write_tagged_records)
    from ..io.vcf import write_vcf_header
    from ..pipeline.caller import _exon_mask_for
    from ..pipeline.engine import process_region

    threads = max(1, cfg.threads)
    order = {c: i for i, (c, _) in enumerate(fasta.contig_lengths)}
    lens = dict(fasta.contig_lengths)
    idx_sorted = sorted(range(len(regions)),
                        key=lambda i: (order.get(regions[i].chr, 1 << 30),
                                       regions[i].start))
    by_contig: Dict[str, List[int]] = {}
    for i in idx_sorted:
        by_contig.setdefault(regions[i].chr, []).append(i)

    n_retried = 0
    vcf_path = output_prefix + ".vcf"
    phased_bam_path = (None if cfg.no_bam_output
                       else output_prefix + ".phased.bam")
    writer = None
    try:
        with open(vcf_path, "w") as vf:
            write_vcf_header(vf, fasta.contig_lengths)
            for chrom in by_contig:
                win = BamFile(bam_path, threads=threads,
                              region=(chrom, 0, lens[chrom]))
                if writer is None and phased_bam_path:
                    writer = BamWriter(phased_bam_path, win.references,
                                       win.lengths,
                                       header_text=win.header_text,
                                       level=cfg.bam_compression_level,
                                       threads=threads)
                for i in by_contig[chrom]:
                    if i in merged:
                        continue
                    n_retried += 1
                    try:
                        reg = regions[i]
                        exon_mask = None
                        if cfg.exon_only and reg.gene_id is not None:
                            exon_mask = _exon_mask_for(reg, exon_regions or {})
                            if exon_mask is None:
                                merged[i] = dict(vcf_lines=[],
                                                 read_assignments={},
                                                 phase_sets={},
                                                 n_fragments=0,
                                                 n_candidates=0)
                                continue
                        res = process_region(win, reg, fasta.fetch(reg.chr),
                                             cfg,
                                             input_candidates=input_candidates,
                                             exon_mask=exon_mask)
                        merged[i] = _payload(res)
                    except Exception:
                        continue      # poisoned region: skip, keep the run
                for i in by_contig[chrom]:
                    for line in merged.get(i, {}).get("vcf_lines", []):
                        vf.write(line + "\n")
                if writer is not None:
                    read_assignments: Dict[str, int] = {}
                    read_phasesets: Dict[str, int] = {}
                    for i in by_contig[chrom]:
                        res = merged.get(i, {})
                        for k, v in res.get("read_assignments", {}).items():
                            read_assignments.setdefault(k, v)
                        for k, v in res.get("phase_sets", {}).items():
                            read_phasesets.setdefault(k, v)
                    for i in by_contig[chrom]:
                        reg = regions[i]
                        ridxs = tagged_record_indices(
                            win, reg.chr, reg.start, reg.end).tolist()
                        write_tagged_records(win, ridxs, read_assignments,
                                             read_phasesets, writer)
                del win
                fasta.evict(chrom)
    finally:
        if writer is not None:
            writer.close()
    if writer is None:
        # no records anywhere → no BAM was written (same contract as the
        # single-process path, caller.py): don't report a nonexistent file
        phased_bam_path = None
    return {"process": 0, "vcf_path": vcf_path,
            "phased_bam_path": phased_bam_path, "n_regions": len(regions),
            "n_retried": n_retried, "stream": True}
