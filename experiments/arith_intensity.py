#!/usr/bin/env python
"""Device measurements behind the phasing engine's tuned constants.

Runs on an accelerator (it refuses the CPU backend) and prints one JSON
line per measurement, then a summary line; ``--out`` also writes the
summary as JSON. Sections (``--sections``, default all):

  matvec   XLA's per-region Dp matvecs, rows (Dp @ [u v]) and cols
           (Dpᵀ @ σ), at the deep shape K=4096, I=512, in both table modes:
           native f64 and the hi/lo f32 split at precision HIGHEST. Time per
           matvec is the slope between two unrolled chains of dependent
           calls inside one program (no dispatch or loop overhead), and the
           achieved bandwidth is 8·K·I bytes (either mode) over that time,
           also as a share of the device's published HBM peak
           (bench.DEVICE_PEAKS). One region's table (16.8 MB) fits the
           H100's 50 MB L2, so a B=16 stack (268 MB) is timed too.
  bsweep   The production bucket schedule
           (parallel/mesh.py::batched_perturbation_phase_stats) at
           B = 1, 2, 4, 8, 16 regions of the deep workload's real
           (K=4096, I=512) loci, per mode: µs per region-iteration. A rise
           past some B is the cliff a bucket-size budget must avoid.
  routing  Host-CPU vs device crossover of the two routing thresholds in
           utils/device.py: phase_region on deep-workload loci cut to phase
           work 2^17..2^26 (cells × rounds), and the candidate kernel on a
           real pileup tiled to 2^14..2^22 columns (2^18..2^26 cells). Warm
           wall per placement, transfers included.

Usage: python experiments/arith_intensity.py [--sections matvec,bsweep]
       [--out FILE]. One device process; inputs are generated from their
seeds under data/.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

K_DEEP, I_DEEP = 4096, 512


def _emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def matvec_section(peak_bps):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from longcallr_tpu.phasing import kernels_fast as KF

    rows = []
    rng = np.random.default_rng(5)
    N1, N2 = 8, 40
    for B in (1, 16):
        dp = rng.standard_normal((B, K_DEEP, I_DEEP))
        hi = dp.astype(np.float32)
        lo = (dp - hi.astype(np.float64)).astype(np.float32)
        dp_d = jnp.asarray(dp)
        dp2_d = jnp.asarray(np.stack([hi, lo], axis=1))      # [B,2,K,I]
        ops = {
            ("f64", "rows"): (dp_d, lambda d, x: d @ x),
            ("f64", "cols"): (dp_d, lambda d, s: d.T @ s),
            ("f32split", "rows"): (dp2_d, KF._matvec_rows),
            ("f32split", "cols"): (dp2_d, KF._matvec_cols),
        }
        for (mode, kind), (tab, fn) in ops.items():
            def chain(tab, x0, n, fn=fn, kind=kind):
                # n dependent calls, unrolled: each output feeds the next
                # operand (rows: [K,2] → first I rows; cols: [I] → tiled to
                # K), scaled to stay finite
                x = x0
                for _ in range(n):
                    y = jax.vmap(fn)(tab, x)
                    if kind == "rows":
                        x = y[:, :I_DEEP, :] * 1e-3
                    else:
                        x = jnp.tile(y, (1, K_DEEP // I_DEEP)) * 1e-3
                return x
            if kind == "rows":
                x0 = jnp.asarray(rng.standard_normal((B, I_DEEP, 2)))
            else:
                x0 = jnp.asarray(rng.standard_normal((B, K_DEEP)))
            f1 = jax.jit(lambda t, x: chain(t, x, N1))
            f2 = jax.jit(lambda t, x: chain(t, x, N2))
            jax.block_until_ready(f1(tab, x0))
            jax.block_until_ready(f2(tab, x0))
            t1s, t2s = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(f1(tab, x0))
                t1s.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                jax.block_until_ready(f2(tab, x0))
                t2s.append(time.perf_counter() - t0)
            per_call = (_median(t2s) - _median(t1s)) / (N2 - N1)
            nbytes = 8 * B * K_DEEP * I_DEEP
            row = {"section": "matvec", "mode": mode, "op": kind, "B": B,
                   "K": K_DEEP, "I": I_DEEP, "us_per_call": per_call * 1e6,
                   "gb_per_s": nbytes / per_call / 1e9}
            if peak_bps:
                row["share_of_hbm_peak"] = nbytes / per_call / peak_bps
            rows.append(_emit(row))
    return rows


def _deep_group():
    """(K, I, [(cands, frags)]) of the deep workload's same-bucket loci."""
    import numpy as np

    from longcallr_tpu.config import preset
    from longcallr_tpu.io.bam import BamFile
    from longcallr_tpu.io.fasta import FastaFile
    from longcallr_tpu.phasing import optimize as O
    from longcallr_tpu.pipeline.engine import prepare_region
    from longcallr_tpu.tiles.regions import extract_isolated_regions_parallel
    from longcallr_tpu.utils.bench_workload import make_deep_workload

    data = os.path.join(HERE, "data")
    os.makedirs(data, exist_ok=True)
    bam_path = os.path.join(data, "deep_bench.bam")
    fa_path = os.path.join(data, "deep_bench.fa")
    make_deep_workload(bam_path, fa_path)
    cfg = preset("hifi-masseq").replace(threads=os.cpu_count() or 4)
    with open(fa_path + ".fai") as f:
        contig, clen = f.readline().split("\t")[:2]
    ref = np.frombuffer(FastaFile(fa_path).fetch(contig), np.uint8).copy()
    bam = BamFile(bam_path, threads=cfg.threads)
    regs = extract_isolated_regions_parallel(bam, [(contig, int(clen))], cfg)
    prepared = [prepare_region(bam, r, ref, cfg) for r in regs]
    groups = {}
    for cands, frags, _ in prepared:
        K0, I0 = frags.p.shape
        kb = (O._bucket(max(1, K0)), O._bucket(max(1, I0)))
        groups.setdefault(kb, []).append((cands, frags))
    (K, I), group = max(groups.items(), key=lambda kv: len(kv[1]))
    return K, I, group, cfg, prepared


def bsweep_section(group_info):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from longcallr_tpu.parallel.mesh import (BatchedRegions,
                                             batched_cross_optimize,
                                             batched_perturbation_phase_stats)
    from longcallr_tpu.phasing import optimize as O

    K, I, group = group_info[:3]
    rows = []

    def run_schedule(B: int, rep: int):
        gb = [group[i % len(group)] for i in range(B)]
        p = np.zeros((B, K, I), np.int8)
        bq = np.zeros((B, K, I), np.uint8)
        rb = np.zeros((B, K), bool)
        sm = np.zeros((B, I), bool)
        n_rounds = np.zeros(B, np.int32)
        rng = np.random.default_rng(100 + rep)
        sigma0 = np.zeros((B, K))
        delta0 = np.zeros((B, I))
        for b, (cands, frags) in enumerate(gb):
            K0, I0 = frags.p.shape
            p[b, :K0, :I0] = frags.p
            bq[b, :K0, :I0] = frags.baseq
            rb[b, :K0] = frags.for_phasing
            sm[b, :I0] = cands.for_phasing
            n_rounds[b] = I0 // 4 + 1
            sigma0[b] = np.where(rb[b], rng.choice([-1.0, 1.0], K), 0.0)
            delta0[b] = rng.choice([-1.0, 1.0], I)
        batch = BatchedRegions(p=jnp.asarray(p), q=jnp.asarray(bq),
                               read_base=jnp.asarray(rb),
                               site_mask=jnp.asarray(sm),
                               conserved=jnp.zeros((B, I), bool))
        sg1, dl1, et1, prob1 = batched_cross_optimize(
            batch, jnp.asarray(sigma0), jnp.asarray(delta0),
            jnp.zeros((B, I)), keep_conserved=False, with_genotype=False)
        keys = jnp.stack([jax.random.PRNGKey(1000 * rep + b)
                          for b in range(B)])
        args = (batch, sg1, dl1, et1, prob1, jnp.asarray(n_rounds), keys)
        jax.block_until_ready(batched_perturbation_phase_stats(*args))
        t0 = time.perf_counter()
        out = batched_perturbation_phase_stats(*args)
        jax.block_until_ready(out)
        return time.perf_counter() - t0, int(out[4])

    for mode, f32 in (("f64", False), ("f32split", True)):
        # the mode is read at trace time and is not part of jit's cache key
        O.USE_F32_KERNELS = f32
        jax.clear_caches()
        for B in (1, 2, 4, 8, 16):
            t0 = time.perf_counter()
            run_schedule(B, 0)                          # compile + warm
            compile_s = time.perf_counter() - t0
            per = []
            for rep in (1, 2):
                dt, it = run_schedule(B, rep)
                per.append((dt / max(1, it) * 1e6, dt, it))
            per_it_us, dt, it = min(per)
            rows.append(_emit({
                "section": "bsweep", "mode": mode, "B": B, "K": K, "I": I,
                "first_call_s": compile_s, "wall_ms": dt * 1e3,
                "batch_iters": it, "us_per_batch_iter": per_it_us,
                "us_per_region_iter": per_it_us / B,
                "tables_mb": 8 * K * I * B / 1e6}))
    O.USE_F32_KERNELS = None
    jax.clear_caches()
    return rows


def _cut(cands, frags, k: int, i: int):
    """The first k reads × first i candidates of a prepared locus (a
    smaller phasing problem of the same data)."""
    import copy

    import numpy as np

    f = copy.copy(frags)
    f.p = frags.p[:k, :i].copy()
    f.baseq = frags.baseq[:k, :i].copy()
    f.qnames = frags.qnames[:k]
    for name in ("num_hete_links", "for_phasing", "downsampled", "haplotag",
                 "assignment", "assignment_score"):
        setattr(f, name, getattr(frags, name)[:k].copy())
    f.ld_counts = {key: v for key, v in frags.ld_counts.items()
                   if key[0] < i and key[1] < i}
    f.cells_off = f.cells_i = f.cells_p = f.cells_q = None
    c = copy.copy(cands)
    for name, val in vars(cands).items():
        if isinstance(val, np.ndarray) and val.shape[:1] == (cands.n,):
            setattr(c, name, val[:i].copy())
    return c, f


def routing_section(group_info):
    import jax
    import numpy as np

    from longcallr_tpu.ops import candidates as C
    from longcallr_tpu.phasing import optimize as O
    from longcallr_tpu.utils import device as D

    K, I, group, cfg, _ = group_info
    cands, frags = group[0]
    cpu = jax.devices("cpu")[0]
    rows = []

    def timed(fn):
        t0 = time.perf_counter()
        fn()                                   # compile + warm
        reps = 3 if time.perf_counter() - t0 < 2.0 else 1
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return _median(ts)

    # phase work = K_pad · I_pad · (I//4 + 1) on the iterative path
    for k, i in ((128, 40), (256, 64), (512, 64), (1024, 128), (2048, 128),
                 (2048, 256), (4096, 256)):
        c, f = _cut(cands, frags, min(k, frags.p.shape[0]), i)
        if c.n <= cfg.max_enum_snps:
            continue
        Kp, Ip = O._bucket(f.p.shape[0]), O._bucket(c.n)
        work = Kp * Ip * (c.n // 4 + 1)
        D.MIN_ACCEL_PHASE_WORK = 0             # always the default device
        t_dev = timed(lambda: O.phase_region(f, c, cfg, seed=1))
        D.MIN_ACCEL_PHASE_WORK = 1 << 62       # always the host CPU
        t_cpu = timed(lambda: O.phase_region(f, c, cfg, seed=1))
        rows.append(_emit({"section": "routing", "what": "phase_region",
                           "K": Kp, "I": Ip, "work": work,
                           "log2_work": float(np.log2(work)),
                           "device_s": t_dev, "cpu_s": t_cpu}))

    # candidate kernel: a real pileup's columns tiled to P
    from longcallr_tpu.io.bam import BamFile
    from longcallr_tpu.io.fasta import FastaFile
    from longcallr_tpu.tiles.pileup import build_pileup

    bam = BamFile(os.path.join(HERE, "data", "deep_bench.bam"))
    fa = FastaFile(os.path.join(HERE, "data", "deep_bench.fa"))
    ref = np.frombuffer(fa.fetch(frags.region.chr), np.uint8).copy()
    base = C._kernel_cols(build_pileup(bam, frags.region, ref, cfg), None)
    n0 = len(base["ref_idx"])
    for lp in range(14, 23, 2):
        P = 1 << lp
        reps = -(-P // n0)
        cols = {k: np.concatenate([v] * reps)[:P] for k, v in base.items()}
        t_dev = timed(lambda: jax.device_get(C.candidate_kernel(cols, cfg)))
        with jax.default_device(cpu):
            t_cpu = timed(lambda: jax.device_get(
                C.candidate_kernel(cols, cfg)))
        rows.append(_emit({"section": "routing", "what": "candidate_kernel",
                           "columns": P, "cells": 16 * P,
                           "log2_cells": lp + 4,
                           "device_s": t_dev, "cpu_s": t_cpu}))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default="matvec,bsweep,routing")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sections = args.sections.split(",")

    import jax

    jax.config.update("jax_enable_x64", True)
    from longcallr_tpu.utils import malloc_tune
    from longcallr_tpu.utils.device import (ensure_cpu_backend_registered,
                                            setup_compile_cache)

    ensure_cpu_backend_registered()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("error: no accelerator (JAX's default backend is the CPU)",
              file=sys.stderr)
        return 1
    malloc_tune.tune()
    setup_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    from bench import DEVICE_PEAKS
    peak = DEVICE_PEAKS.get(dev.device_kind, {}).get("hbm_bytes_per_s")
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "nvidia_smi": smi.strip(), "hbm_peak_bytes_per_s": peak}
    _emit(out)
    if "matvec" in sections:
        out["matvec"] = matvec_section(peak)
    if "bsweep" in sections or "routing" in sections:
        group_info = _deep_group()
        if "bsweep" in sections:
            out["bsweep"] = bsweep_section(group_info)
        if "routing" in sections:
            out["routing"] = routing_section(group_info)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"done": sections}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
