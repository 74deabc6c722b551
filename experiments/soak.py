"""Multi-million-read --stream soak.

Generates a ~2M-read / ~25-contig whole-genome workload with a streaming
writer (one locus of reads in memory at a time — the bench generator holds
the whole read set, which would be ~12 GB here), then runs the per-contig
streaming caller twice (cold, then steady-state) and reports wall,
reads/s, RSS floor/peak, and record-count consistency vs planted truth.

Usage:  python experiments/soak.py [--contigs 25] [--loci 50] [--cov 120]
The BAM is cached under data/soak/ with a params sidecar (gitignored);
delete the sidecar to force regeneration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from longcallr_tpu.io import bam as bamio                      # noqa: E402
from longcallr_tpu.io.bai import build_bai                    # noqa: E402
from longcallr_tpu.io.fasta import write_fasta                # noqa: E402
from longcallr_tpu.utils.bench_workload import _ALTS, _BASES  # noqa: E402


def generate(bam_path: str, fa_path: str, n_contigs: int, loci_per_contig: int,
             locus_len: int, coverage: int, spacing: int, read_len: int,
             err_rate: float, gap: int, seed: int) -> dict:
    params = dict(version=1, kind="soak", n_contigs=n_contigs,
                  loci=loci_per_contig, locus_len=locus_len,
                  coverage=coverage, spacing=spacing, read_len=read_len,
                  err_rate=err_rate, gap=gap, seed=seed)
    side = bam_path + ".params.json"
    if (os.path.exists(bam_path) and os.path.exists(fa_path + ".fai")
            and os.path.exists(bam_path + ".bai") and os.path.exists(side)):
        with open(side) as f:
            old = json.load(f)
        if {k: old.get(k) for k in params} == params:
            return old
    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    margin = 2_000
    L = margin + loci_per_contig * (locus_len + gap)
    names = [f"chr{c + 1}" for c in range(n_contigs)]
    n_reads = n_snps = 0
    t0 = time.monotonic()
    # pass 1: references + truth (per contig, written immediately);
    # reads stream straight into the BGZF writer one locus at a time
    tmp = bam_path + ".tmp"
    fa_handles = {}
    with bamio.BamWriter(tmp, names, [L] * n_contigs, threads=4) as w:
        for tid in range(n_contigs):
            ref = _BASES[rng.integers(0, 4, size=L)]
            hap1 = ref.copy()
            cur = margin
            for _ in range(loci_per_contig):
                pos = cur + 200
                while pos < cur + locus_len - 200:
                    p = int(pos + rng.integers(0, max(1, spacing // 4)))
                    alts = _ALTS[int(ref[p])]
                    hap1[p] = alts[int(rng.integers(0, len(alts)))]
                    n_snps += 1
                    pos += spacing
                cur += locus_len + gap
            haps = {1: hap1, 2: ref}
            cur = margin
            for _ in range(loci_per_contig):
                n = int(np.ceil(locus_len * coverage / read_len))
                starts = rng.integers(cur, cur + locus_len - read_len, size=n)
                starts.sort()
                for i in range(n):
                    hap = 1 + (i % 2)
                    pos = int(starts[i])
                    seq = haps[hap][pos:pos + read_len].copy()
                    errs = rng.random(read_len) < err_rate
                    ne = int(errs.sum())
                    if ne:
                        seq[errs] = _BASES[rng.integers(0, 4, size=ne)]
                    quals = rng.integers(25, 31, size=read_len).astype(np.uint8)
                    w.write_record(
                        qname=f"s{tid}_{n_reads:08d}", flag=0, ref_id=tid,
                        pos=pos, mapq=60,
                        cigar=bamio.encode_cigar([(read_len, "M")]),
                        seq=bytes(seq), qual=quals,
                        tags=bamio.make_tag_bytes("de", "f", err_rate))
                    n_reads += 1
                cur += locus_len + gap
            fa_handles[names[tid]] = bytes(ref)
    os.replace(tmp, bam_path)
    write_fasta(fa_path, fa_handles)
    build_bai(bam_path)
    params.update(n_reads=n_reads, n_snps=n_snps,
                  gen_seconds=round(time.monotonic() - t0, 1),
                  bam_mb=round(os.path.getsize(bam_path) / 1e6, 1))
    with open(side, "w") as f:
        json.dump(params, f)
    return params


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--contigs", type=int, default=25)
    ap.add_argument("--loci", type=int, default=50)
    ap.add_argument("--locus-len", type=int, default=40_000)
    ap.add_argument("--cov", type=int, default=120)
    ap.add_argument("--spacing", type=int, default=200)
    ap.add_argument("--read-len", type=int, default=3_000)
    ap.add_argument("--runs", type=int, default=2,
                    help="first run is cold (compiles); last is steady")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from longcallr_tpu.utils import malloc_tune
    malloc_tune.tune()
    os.makedirs("data/soak", exist_ok=True)
    bam_path, fa_path = "data/soak/soak.bam", "data/soak/soak.fa"
    params = generate(bam_path, fa_path, args.contigs, args.loci,
                      args.locus_len, args.cov, args.spacing, args.read_len,
                      err_rate=0.002, gap=40_000, seed=20_260_820)
    print(json.dumps({k: params[k] for k in
                      ("n_reads", "n_snps", "bam_mb")} |
                     {"gen_seconds": params.get("gen_seconds")}), flush=True)

    from bench import _RssPeak
    from longcallr_tpu.config import preset
    from longcallr_tpu.pipeline.caller import run_streaming
    import jax

    cfg = preset("hifi-masseq").replace(threads=os.cpu_count() or 4)
    out = None
    rec_counts = []
    from longcallr_tpu.pipeline.engine import STAGE_TOTALS
    for r in range(args.runs):
        import gc
        gc.collect()
        malloc_tune.trim()
        st0 = dict(STAGE_TOTALS)
        with _RssPeak() as rss:
            t0 = time.monotonic()
            out = run_streaming(bam_path, fa_path, "data/soak/out", cfg)
            wall = time.monotonic() - t0
        rec_counts.append(out.n_records)
        print(json.dumps({
            "run": r, "wall_s": round(wall, 1),
            "reads_per_s": round(params["n_reads"] / wall, 1),
            "records": out.n_records, "n_snps": params["n_snps"],
            "rss_floor_mb": round(rss.floor, 1),
            "rss_peak_mb": round(rss.peak, 1),
            "platform": jax.devices()[0].platform,
            "stage_seconds": {k: round(v, 1)
                              for k, v in out.stage_seconds.items()},
            # engine-stage attribution for THIS run (pileup/candidates/
            # fragments/assign are pool-thread sums and can exceed wall;
            # phase_* run on the wave pipeline's phase worker)
            "engine_stages": {k: round(v - st0.get(k, 0.0), 1)
                              for k, v in STAGE_TOTALS.items()
                              if v - st0.get(k, 0.0) > 0.05},
        }), flush=True)
    print(json.dumps({
        "records_consistent": len(set(rec_counts)) == 1,
        "records_vs_truth": round(rec_counts[-1] / params["n_snps"], 5),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
