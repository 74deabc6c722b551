"""Command-line interface, mirroring the reference CLI
(``longcallR/src/main.rs:39-185``) flag-for-flag with identical presets."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from .config import PRESET_NAMES, preset

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="longcallr-tpu",
        description="SNP calling and phasing from long-read RNA-seq")
    # clap derives -V/--version from #[command(version)] (main.rs:40)
    from . import __version__
    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("-b", "--bam-path", required=True,
                   help="Input BAM file (must be sorted)")
    p.add_argument("-f", "--ref-path", required=True,
                   help="Reference FASTA file (requires .fai)")
    p.add_argument("-a", "--annotation", help="Annotation file, GFF3 or GTF")
    p.add_argument("-o", "--output", required=True, help="Output file prefix")
    p.add_argument("-r", "--region",
                   help="Region chr:start-end (1-based, left-closed right-open)")
    p.add_argument("-x", "--contigs", nargs="*", help="Contigs to process")
    p.add_argument("-v", "--input-vcf", help="Input VCF of candidate SNPs")
    p.add_argument("-t", "--threads", type=int, default=None)
    p.add_argument("-p", "--preset", required=True, choices=PRESET_NAMES)
    # tunables (None → preset default)
    for name, typ in [
        ("min-allele-freq", float), ("min-allele-freq-include-intron", float),
        ("low-allele-frac-cutoff", float), ("low-allele-cnt-cutoff", int),
        ("min-read-length", int), ("min-mapq", int), ("min-baseq", int),
        ("divergence", float), ("min-depth", int), ("max-depth", int),
        ("min-qual", int), ("distance-to-read-end", int),
        ("polya-tail-length", int), ("dense-win-size", int),
        ("min-dense-cnt", int), ("min-linkers", int), ("max-enum-snps", int),
        ("min-phase-score", float), ("min-read-assignment-diff", float),
        ("truncation-coverage", int), ("downsample-depth", int),
    ]:
        p.add_argument(f"--{name}", type=typ, default=None)
    p.add_argument("--bam-compression-level", type=int, default=None,
                   choices=range(0, 10), metavar="[0-9]",
                   help="BGZF deflate level of the phased BAM "
                        "(default 6 = htslib; 1 writes ~3x faster)")
    p.add_argument("--strand-bias", type=lambda s: s.lower() == "true",
                   default=None)
    p.add_argument("--truncation", action="store_true")
    p.add_argument("--downsample", action="store_true")
    p.add_argument("--exon-only", action="store_true")
    p.add_argument("--no-bam-output", action="store_true")
    p.add_argument("--index-output", action="store_true",
                   help="Write a .bai index for the phased BAM output")
    p.add_argument("--get-blocks", action="store_true",
                   help="Show all regions to be processed and exit")
    p.add_argument("--resume", action="store_true",
                   help="Keep a region checkpoint and skip completed regions")
    p.add_argument("--batched", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="Bucketed multi-region device pipeline (batched "
                        "candidate kernel + bucketed phasing; the device "
                        "scaling path). Default: on for multi-region runs. "
                        "--no-batched forces the per-region loop")
    p.add_argument("--stream", dest="stream", action="store_true",
                   default=None,
                   help="Whole-genome mode: one contig resident at a time "
                        "(needs a .bai next to the BAM). Default AUTO: "
                        "engaged for indexed BAMs larger than "
                        "LONGCALLR_STREAM_AUTO_MB (1024) when no -r is "
                        "given; --no-stream forces the resident pipeline")
    p.add_argument("--no-stream", dest="stream", action="store_false",
                   help=argparse.SUPPRESS)
    p.add_argument("--somatic", action="store_true",
                   help="Enable somatic-by-het detection (off in the reference)")
    p.add_argument("--somatic-purity", type=float, default=None,
                   help="Tumor purity channel weight for --somatic (default 0.3)")
    p.add_argument("--profile-dir", default=None,
                   help="Write a jax.profiler trace of the run to this dir")
    # multi-process (pod) launch (parallel/multihost.py): mirrors how the reference
    # exposes every mode through one binary (main.rs:228-491). All three
    # flags go together; each pod process runs this same command with its
    # own --process-id. See docs/usage.md for a 2-process localhost recipe.
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address (process 0's "
                        "host:port); enables multi-process pod mode")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Total process count of the pod")
    p.add_argument("--process-id", type=int, default=None,
                   help="This process's index in [0, num-processes)")
    p.add_argument("--platform", default=None,
                   help="Force the JAX platform (cpu, cuda) before any "
                        "backend/distributed init — overrides environment "
                        "presets that env vars cannot")
    p.add_argument("--log-level", default="INFO")
    return p


def config_from_args(args) -> "CallerConfig":
    overrides = dict(
        threads=args.threads,
        min_allele_freq=args.min_allele_freq,
        min_allele_freq_include_intron=args.min_allele_freq_include_intron,
        low_allele_frac_cutoff=args.low_allele_frac_cutoff,
        low_allele_cnt_cutoff=args.low_allele_cnt_cutoff,
        min_read_length=args.min_read_length,
        min_mapq=args.min_mapq, min_baseq=args.min_baseq,
        divergence=args.divergence, min_depth=args.min_depth,
        max_depth=args.max_depth, min_qual=args.min_qual,
        distance_to_read_end=args.distance_to_read_end,
        polya_tail_length=args.polya_tail_length,
        dense_win_size=args.dense_win_size, min_dense_cnt=args.min_dense_cnt,
        min_linkers=args.min_linkers, max_enum_snps=args.max_enum_snps,
        min_phase_score=args.min_phase_score,
        min_read_assignment_diff=args.min_read_assignment_diff,
        truncation_coverage=args.truncation_coverage,
        downsample_depth=args.downsample_depth,
        bam_compression_level=args.bam_compression_level,
        strand_bias=args.strand_bias,
    )
    cfg = preset(args.preset, **overrides)
    cfg = cfg.replace(truncation=args.truncation, downsample=args.downsample,
                      exon_only=args.exon_only,
                      no_bam_output=args.no_bam_output,
                      somatic=args.somatic,
                      threads=args.threads or 1)
    if args.somatic_purity is not None:
        cfg = cfg.replace(somatic_purity=args.somatic_purity)
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level,
                        format="%(asctime)s %(levelname)s %(message)s")
    pod_flags = (args.coordinator, args.num_processes, args.process_id)
    pod = any(f is not None for f in pod_flags)
    if pod and any(f is None for f in pod_flags):
        print("error: --coordinator, --num-processes and --process-id must "
              "be given together", file=sys.stderr)
        return 2
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    if pod:
        # BEFORE any backend initialisation (jax.distributed contract)
        from .parallel.multihost import initialize_distributed
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)
    from .utils import malloc_tune
    malloc_tune.tune()
    from .utils.device import setup_compile_cache
    setup_compile_cache()
    cfg = config_from_args(args)
    print(f"Preset: {args.preset}")

    from .io.bam import BamFile
    from .io.fasta import FastaFile
    from .pipeline.caller import build_regions, run

    if args.get_blocks:
        bam = BamFile(args.bam_path, threads=max(1, cfg.threads))
        fasta = FastaFile(args.ref_path)
        regions, _ = build_regions(bam, fasta, cfg, args.region, args.contigs,
                                   args.annotation)
        for reg in regions:
            if reg.gene_id is None:
                print(f"{reg.chr}:{reg.start}-{reg.end} {reg.max_coverage}")
            else:
                print(f'{reg.chr}:{reg.start}-{reg.end} {reg.max_coverage} '
                      f'"{reg.gene_id}"')
        return 0

    if cfg.exon_only and not args.annotation:
        print("error: exon_only is set, but annotation file is not provided",
              file=sys.stderr)
        return 2

    if pod:
        # multi-process pod: shard regions across processes, gather, and
        # let process 0 serialise (parallel/multihost.py). Has its own
        # --stream AUTO (per-contig BAI-windowed shard processing).
        from .parallel.multihost import run_multihost
        go = lambda: run_multihost(args.bam_path, args.ref_path, args.output,
                                   cfg, stream=args.stream,
                                   input_vcf=args.input_vcf,
                                   input_region=args.region,
                                   contigs=args.contigs,
                                   anno_path=args.annotation,
                                   resume=args.resume)
        if args.profile_dir:
            import jax
            with jax.profiler.trace(args.profile_dir):
                res = go()
        else:
            res = go()
        if isinstance(res, dict):   # pod summary (process 0 or shard)
            import json
            print(json.dumps(res))
            from .parallel.multihost import gather_degraded
            if gather_degraded():
                # degraded survivor (peer died mid-gather): the distributed
                # client's teardown barrier would block on the dead peer
                # and LOG(FATAL); outputs are written — leave immediately
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(0)
            return 0
        out = res                   # 1-process degenerate: CallerOutputs
        print(f"wrote {out.n_records} records to {out.vcf_path}")
        return 0

    if args.stream is None and not args.region:
        # AUTO: a big indexed BAM should not be whole-resident by default —
        # the reference streams htslib windows per task and never holds the
        # decompressed BAM (thread.rs:77-101); stream == resident outputs
        # are byte-identical (tests/test_stream_genome.py)
        auto_mb = float(os.environ.get("LONGCALLR_STREAM_AUTO_MB", "1024"))
        if (os.path.exists(args.bam_path + ".bai")
                and os.path.getsize(args.bam_path) > auto_mb * 1e6):
            log.info("BAM > %.0f MB with a .bai: using --stream "
                     "(--no-stream forces the resident pipeline)", auto_mb)
            args.stream = True
    if args.stream:
        from .pipeline.caller import run_streaming
        if args.region:
            print("error: --stream does not take -r (use the default "
                  "pipeline for single-region runs)", file=sys.stderr)
            return 2
        go = lambda: run_streaming(args.bam_path, args.ref_path, args.output,
                                   cfg, contigs=args.contigs,
                                   input_vcf=args.input_vcf,
                                   anno_path=args.annotation,
                                   resume=args.resume,
                                   batched=args.batched)
    else:
        go = lambda: run(args.bam_path, args.ref_path, args.output, cfg,
                         input_vcf=args.input_vcf, input_region=args.region,
                         contigs=args.contigs, anno_path=args.annotation,
                         resume=args.resume, batched=args.batched)
    if args.profile_dir:
        import jax
        with jax.profiler.trace(args.profile_dir):
            out = go()
    else:
        out = go()
    print(f"wrote {out.n_records} records to {out.vcf_path} "
          f"({out.n_phased_sites} phased sites, {out.n_candidates} candidates, "
          f"{out.n_assigned_reads}/{out.n_fragments} reads haplotagged)")
    if out.phased_bam_path:
        print(f"wrote phased BAM to {out.phased_bam_path}")
        if args.index_output:
            from .io.bai import build_bai
            print(f"wrote index to {build_bai(out.phased_bam_path)}")
    for k, v in out.stage_seconds.items():
        print(f"  stage {k}: {v:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
