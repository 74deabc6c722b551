#!/usr/bin/env python
"""Bring-up smoke test: the calling-and-phasing path on one NVIDIA GPU.

    python chip_smoke.py           # one card (the default)
    python chip_smoke.py --four    # the multi-card paths, on four cards

One card. Phases, each fatal on failure:
  device   refuses any platform but "gpu" (checked in a child process);
           runs the gpu-marked unit tests on the card (pytest -m gpu, child
           process); prints the card's name and power limit, device kind
           and memory, JAX version, compile-cache directory and the native
           BGZF backend.
  kernels  one deep bucket (B=4 real loci at K=4096, I=512): the phasing
           matvecs against numpy f64 and the same functions on the CPU
           backend, one full ascent, the batched bucket programs (states
           equal, sums within tolerance), compiled.memory_analysis() of the
           bucket programs; the candidate kernel on a real pileup of ≥ 2^20
           columns (routed to the card) against its CPU-backend run.
  deep     the CLI (longcallr_tpu.cli.main, in-process) on the deep workload
           (4 loci × ~4096 reads × ~512 het SNPs, 126 perturbation rounds),
           twice: both VCFs byte-identical, and VCF + HP/PS tags
           byte-identical to a CPU-backend run in a subprocess
           (JAX_PLATFORMS=cpu, never opens the card); accuracy against the
           planted truth; the engine's counters show the phasing buckets ran
           on the card and no deep problem fell back to the CPU.
  stream   the 104k-read, 5-contig genome workload through the CLI with
           --stream: VCF byte-identical to the resident run and to a
           CPU-backend run (its candidate kernel runs on the card).

Four cards (--four), each compared with its one-card counterpart:
  pod      the deep workload through a 4-process pod (the CLI's
           --coordinator/--num-processes/--process-id), one card and one
           locus per process, while this process holds no card; against one
           process, which phases the four loci as one bucket.
  mesh     the deep workload through run(mesh=make_mesh(4, 1)) against
           mesh=None.
  giant    one ~64k-read × ~1000-SNP locus (2^26 padded cells) through the
           CLI, reads-sharded over the four cards; its PhaseState against
           phase_region_sharded on a one-card mesh.

Inputs are generated from their seeds under data/. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
DATA = os.path.join(HERE, "data", "smoke")
THREADS = str(os.cpu_count() or 4)
# one locus of ~64k reads × ~1000 het SNPs: 65536 × 1024 = 2^26 padded cells
GIANT = dict(n_regions=1, region_len=160_000, snp_spacing=160, coverage=400,
             read_len=1000, gap=20_000, seed=20_261_016, contig="chrG")


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    say(f"  ok: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cli(args) -> None:
    from longcallr_tpu.cli import main
    rc = main(list(args) + ["--log-level", "WARNING"])
    if rc != 0:
        raise RuntimeError(f"cli {args} returned {rc}")


def cli_subprocess(args, env_extra, log_path) -> None:
    """The CLI in a child process (own backend, own card use)."""
    code = ("import sys; from longcallr_tpu.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, **env_extra)
    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, "-c", code] + list(args)
                            + ["--log-level", "WARNING"], cwd=HERE, env=env,
                            stdout=log, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        with open(log_path) as f:
            raise RuntimeError(f"cli subprocess rc={rc}: {f.read()[-3000:]}")


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def hp_ps_tags(bam_path: str):
    from longcallr_tpu.io.bam import BamFile
    return sorted((r.qname, r.get_tag("HP"), r.get_tag("PS"))
                  for r in BamFile(bam_path))


def stage_snapshot():
    from longcallr_tpu.pipeline.engine import STAGE_TOTALS
    return dict(STAGE_TOTALS)


def stage_delta(before):
    after = stage_snapshot()
    return {k: round(v - before.get(k, 0.0), 4) for k, v in after.items()
            if v - before.get(k, 0.0) != 0}


def deep_workload():
    from longcallr_tpu.utils.bench_workload import make_deep_workload
    bam = os.path.join(DATA, "deep.bam")
    fa = os.path.join(DATA, "deep.fa")
    return bam, fa, make_deep_workload(bam, fa)


def genome_workload():
    from longcallr_tpu.utils.bench_workload import make_genome_workload
    bam = os.path.join(DATA, "genome.bam")
    fa = os.path.join(DATA, "genome.fa")
    spec = [(f"chr{i + 1}", [(40_000, 120, 200)] * 13) for i in range(5)]
    return bam, fa, make_genome_workload(bam, fa, contigs=spec)


def prepared_regions(bam_path, fa_path, cfg, contigs=None):
    """[(region, cands, frags, apply_ds)] through the pipeline's own host
    stages."""
    import numpy as np

    from longcallr_tpu.io.bam import BamFile
    from longcallr_tpu.io.fasta import FastaFile
    from longcallr_tpu.pipeline.engine import prepare_region
    from longcallr_tpu.tiles.regions import extract_isolated_regions_parallel

    fasta = FastaFile(fa_path)
    bam = BamFile(bam_path, threads=cfg.threads)
    out = []
    for name, ln in zip(bam.references, bam.lengths):
        if contigs is not None and name not in contigs:
            continue
        ref = np.frombuffer(fasta.fetch(name), np.uint8).copy()
        for r in extract_isolated_regions_parallel(bam, [(name, ln)], cfg):
            out.append((r,) + tuple(prepare_region(bam, r, ref, cfg)))
    return out


# ---------------------------------------------------------------- one card

def _probe_devices():
    """(platform, count, kind) from a child process, so this process opens
    no card before the child phases that need one run."""
    code = ("import jax; d = jax.devices(); "
            "print(d[0].platform, len(d), d[0].device_kind)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split(maxsplit=2)
    return out[0], int(out[1]), out[2].strip()


def require_gpus(n: int) -> None:
    plat, count, kind = _probe_devices()
    if plat != "gpu" or count < n:
        print(f"error: no GPU for this run: JAX's default backend has "
              f"{count} x {plat} ({kind}), {n} GPU(s) needed",
              file=sys.stderr)
        sys.exit(1)


def phase_gpu_tests():
    """The gpu-marked unit tests, on the card, in a child process."""
    say("== gpu-marked tests (pytest -m gpu)")
    # only the files that hold such tests: collecting the whole suite would
    # import modules that an installed top-level package may shadow
    tests = os.path.join(HERE, "tests")
    files = []
    for name in sorted(os.listdir(tests)):
        if name.startswith("test_") and name.endswith(".py"):
            with open(os.path.join(tests, name)) as f:
                if "pytest.mark.gpu" in f.read():
                    files.append(os.path.join(tests, name))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rs",
         "-p", "no:cacheprovider"] + files,
        cwd=HERE, env=dict(os.environ, LONGCALLR_TEST_GPU="1"),
        capture_output=True, text=True)
    tail = (p.stdout.strip().splitlines() or [""])[-1]
    if p.returncode != 0:
        say(p.stdout[-3000:] + p.stderr[-2000:])
    check(p.returncode == 0 and " passed" in tail and "skipped" not in tail,
          f"gpu-marked tests pass on the card ({tail.strip('= ')})")


def phase_device():
    import jax

    from longcallr_tpu import native
    from longcallr_tpu.utils.device import setup_compile_cache

    dev = jax.devices()[0]
    check(dev.platform == "gpu", "JAX's default device is a GPU")
    say("== device")
    say(f"nvidia-smi: {nvidia_smi()}")
    stats = dev.memory_stats() or {}
    say(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
        f"memory limit {stats.get('bytes_limit', 0) / 2**30:.1f} GiB")
    say(f"jax {jax.__version__}; compile cache {setup_compile_cache()}")
    lib = native.lib()
    say("native BGZF backend: "
        + ("none (numpy fallback)" if lib is None else
           {0: "zlib", 1: "libdeflate"}.get(lib.bgzf_native_backend(),
                                            "unknown")))
    return dev


def _bucket_arrays(group, K, I):
    import numpy as np

    B = len(group)
    p = np.zeros((B, K, I), np.int8)
    bq = np.zeros((B, K, I), np.uint8)
    rb = np.zeros((B, K), bool)
    sm = np.zeros((B, I), bool)
    rng = np.random.default_rng(7)
    sigma0 = np.zeros((B, K))
    delta0 = np.ones((B, I))
    for b, (_, cands, frags, _) in enumerate(group):
        K0, I0 = frags.p.shape
        p[b, :K0, :I0] = frags.p
        bq[b, :K0, :I0] = frags.baseq
        rb[b, :K0] = frags.for_phasing
        sm[b, :I0] = cands.for_phasing
        sigma0[b] = np.where(rb[b], rng.choice([-1.0, 1.0], K), 0.0)
        delta0[b, :I0] = rng.choice([-1.0, 1.0], I0)
    return p, bq, rb, sm, sigma0, delta0


def mem(compiled) -> str:
    m = compiled.memory_analysis()
    return ", ".join(f"{k} {getattr(m, k + '_in_bytes') / 2**20:.1f} MiB"
                     for k in ("argument_size", "output_size", "temp_size",
                               "generated_code_size"))


def phase_kernels(deep_prepared, cfg, K=4096, I=512):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from longcallr_tpu.parallel.mesh import (BatchedRegions,
                                             batched_cross_optimize,
                                             batched_overall_probability,
                                             batched_perturbation_phase)
    from longcallr_tpu.phasing import kernels_fast as KF
    from longcallr_tpu.phasing import optimize as O
    from longcallr_tpu.phasing.kernels import CompactCells, make_cell_tables_np

    say(f"== kernels (one deep bucket, B=4, K={K}, I={I})")
    group = deep_prepared[:4]
    check(len(group) == 4 and all(
        O._bucket(f.p.shape[0]) == K and O._bucket(f.p.shape[1]) == I
        for _, _, f, _ in group), f"deep loci fill one ({K}, {I}) bucket")
    cpu = jax.devices("cpu")[0]
    p, bq, rb, sm, sigma0, delta0 = _bucket_arrays(group, K, I)
    eta0 = np.zeros((4, I))
    f32 = O._f32_mode()
    say(f"  default phasing mode on the card: "
        f"{'hi/lo f32 split (HIGHEST)' if f32 else 'native f64'}")
    # f64 sums: rtol 1e-12 (summation order only). The split's documented
    # contract is 1e-4 absolute on a per-read or per-SNP sum; an objective
    # adds up K such per-read sums, so it is held to 1e-6 relative.

    def close(got, want, what, objective=False):
        got, want = np.asarray(got), np.asarray(want)
        if not f32:
            tol = dict(rtol=1e-12, atol=1e-12 * float(np.abs(want).max()))
        elif objective:
            tol = dict(rtol=1e-6, atol=0)
        else:
            tol = dict(rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, want, **tol)
        err = float(np.abs(got - want).max())
        say(f"  ok: {what} (max abs diff {err:.3g})")

    @jax.jit
    def matvecs(p8, q8, rb1, sg, sm1, x, s):
        ft = O._fast_tables_for(CompactCells(p8, q8), rb1, sg, sm1)
        if O._f32_mode():
            return KF._matvec_rows(ft.dp2, x), KF._matvec_cols(ft.dp2, s)
        return ft.dp @ x, ft.dp.T @ s

    rng = np.random.default_rng(11)
    x = rng.choice([-1.0, 0.0, 1.0], (I, 2))
    rm = rb[0] & (sigma0[0] != 0)
    s = np.where(rm, rng.choice([-1.0, 1.0], K), 0.0)
    args0 = (p[0], bq[0], rb[0], sigma0[0], sm[0], x, s)
    gpu_r, gpu_c = matvecs(*args0)
    with jax.default_device(cpu):
        cpu_r, cpu_c = matvecs(*args0)
    ct = make_cell_tables_np(p[0], bq[0])
    m = sm[0][None, :] & ct.exists
    dp = np.where(m, ct.l1m - ct.lerr, 0.0) * ct.p
    close(gpu_r, dp @ x, "Dp @ [u v] on the card vs numpy f64")
    close(gpu_c, dp.T @ s, "Dpᵀ @ σ on the card vs numpy f64")
    close(gpu_r, cpu_r, "Dp @ [u v] on the card vs the CPU backend")
    close(gpu_c, cpu_c, "Dpᵀ @ σ on the card vs the CPU backend")

    st0 = O.PhaseState(jnp.asarray(sigma0[0]), jnp.asarray(delta0[0]),
                       jnp.asarray(eta0[0]))
    cons = np.zeros(I, bool)
    asc = lambda: O.cross_optimize_fast(
        CompactCells(jnp.asarray(p[0]), jnp.asarray(bq[0])), st0,
        jnp.asarray(rb[0]), jnp.asarray(sm[0]), jnp.asarray(cons),
        with_genotype=False, keep_conserved=True)
    st_g, pr_g = asc()
    with jax.default_device(cpu):
        st_c, pr_c = asc()
    for a, b, n in zip(st_g, st_c, ("sigma", "delta", "eta")):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"cross_optimize_fast final {n} equal to the CPU backend")
    close(pr_g, pr_c, "cross_optimize_fast objective vs the CPU backend",
          objective=True)

    def bucket(dev=None):
        put = (lambda a: jax.device_put(a, dev)) if dev else jnp.asarray
        batch = BatchedRegions(p=put(p), q=put(bq), read_base=put(rb),
                               site_mask=put(sm),
                               conserved=put(np.zeros((4, I), bool)))
        sg, dl, et, pr1 = batched_cross_optimize(
            batch, put(sigma0), put(delta0), put(eta0), keep_conserved=True)
        pr2 = batched_overall_probability(batch, sg, dl, et)
        keys = jnp.stack([jax.random.PRNGKey(100 + b) for b in range(4)])
        # 8 rounds: the full 126-round schedule runs end to end below
        sched = (batch, sg, dl, et, pr1, put(np.full(4, 8, np.int32)),
                 put(keys))
        out = batched_perturbation_phase(*sched)
        return [np.asarray(a) for a in (sg, dl, et, pr1, pr2) + tuple(out)], \
            sched

    got, sched = bucket()
    with jax.default_device(cpu):
        want, _ = bucket(cpu)
    names = ("ascent sigma", "ascent delta", "ascent eta", "ascent prob",
             "overall prob", "schedule sigma", "schedule delta",
             "schedule eta", "schedule prob")
    for g, w, n in zip(got, want, names):
        if n.endswith("prob"):
            close(g, w, f"bucket {n} vs the CPU backend", objective=True)
        else:
            check(np.array_equal(g, w), f"bucket {n} equal to the CPU backend")

    comp = batched_perturbation_phase.lower(*sched).compile()
    say(f"  memory_analysis(batched_perturbation_phase, B=4): {mem(comp)}")
    # the fused whole-phase bucket program exists in f32 split mode only
    prev = O.USE_F32_KERNELS
    O.USE_F32_KERNELS = True
    try:
        from longcallr_tpu.parallel.mesh import batched_phase_fused
        bid = jnp.full((4, I), -1, jnp.int32)
        comp = batched_phase_fused.lower(
            sched[0], sched[1], sched[2], sched[3], bid, sched[5],
            sched[6]).compile()
        say(f"  memory_analysis(batched_phase_fused, B=4, f32 split): "
            f"{mem(comp)}")
    finally:
        O.USE_F32_KERNELS = prev


def phase_candidates(genome, cfg, min_cols=1 << 20):
    import jax
    import numpy as np

    from longcallr_tpu.io.bam import BamFile
    from longcallr_tpu.io.fasta import FastaFile
    from longcallr_tpu.ops import candidates as C
    from longcallr_tpu.tiles.pileup import build_pileup
    from longcallr_tpu.tiles.regions import extract_isolated_regions_parallel
    from longcallr_tpu.utils.device import small_problem_device

    say("== candidate kernel (real pileup, >= 2^20 columns)")
    bam_path, fa_path, _ = genome
    bam = BamFile(bam_path, threads=cfg.threads)
    fasta = FastaFile(fa_path)
    cols, n = [], 0
    for name, ln in zip(bam.references, bam.lengths):
        ref = np.frombuffer(fasta.fetch(name), np.uint8).copy()
        for r in extract_isolated_regions_parallel(bam, [(name, ln)], cfg):
            cols.append(C._kernel_cols(build_pileup(bam, r, ref, cfg), None))
            n += len(cols[-1]["ref_idx"])
        if n >= min_cols:
            break
    check(n >= min_cols, f"pileup of {n} columns from the genome workload")
    Ppad = C._round_up(n)
    padded = C._pad_cols({k: np.concatenate([c[k] for c in cols])
                          for k in cols[0]}, Ppad)
    check(small_problem_device(Ppad * 16) is None,
          "small_problem_device routes it to the card")
    got = jax.device_get(C.candidate_kernel(padded, cfg))
    with jax.default_device(jax.devices("cpu")[0]):
        want = jax.device_get(C.candidate_kernel(padded, cfg))
    n_sel = int((want["category"] != 0).sum())
    for k in sorted(want):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype == np.float64:
            # libm differences only: a few ulps of the field's scale
            fin = np.isfinite(w)
            scale = float(np.abs(w[fin]).max()) if fin.any() else 0.0
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12 * scale)
        else:
            # decisions, and the f32 allele fractions the VCF prints
            # (correctly rounded quotients on every placement)
            np.testing.assert_array_equal(g, w, err_msg=k)
    say(f"  ok: {len(want)} kernel outputs agree with the CPU backend "
        f"(f64 rtol 1e-12; f32 fractions and decisions exact; {n_sel} "
        f"candidate columns)")


def phase_deep(deep, cfg):
    from bench import accuracy_metrics
    from longcallr_tpu.utils import device as D

    say("== deep workload through the CLI")
    bam, fa, params = deep
    prefix = os.path.join(DATA, "deep_gpu")
    args = ["-b", bam, "-f", fa, "-o", prefix, "-p", "hifi-masseq",
            "-t", THREADS]
    walls, stages, vcfs = [], [], []
    degraded0 = D.DEGRADED_PLACEMENTS
    for run in ("cold", "warm"):
        before = stage_snapshot()
        t0 = time.perf_counter()
        cli(args)
        walls.append(time.perf_counter() - t0)
        stages.append(stage_delta(before))
        vcfs.append(read_bytes(prefix + ".vcf"))
        say(f"  {run} wall {walls[-1]:.3f} s; STAGE_TOTALS "
            f"{json.dumps(stages[-1])}")
    check(vcfs[0] == vcfs[1], "two card runs give byte-identical VCFs")
    check(D.DEGRADED_PLACEMENTS == degraded0,
          "DEGRADED_PLACEMENTS == 0 (no deep problem fell back to the CPU)")
    check(stages[1].get("phase_buckets_device", 0) > 0,
          f"{stages[1].get('phase_buckets_device', 0):.0f} phasing "
          f"bucket(s) ran on the card")
    say(f"  phase_safety_recompute runs: "
        f"{stages[1].get('phase_safety_recompute', 0):.0f}")

    cpu_prefix = os.path.join(DATA, "deep_cpu")
    t0 = time.perf_counter()
    cli_subprocess(["-b", bam, "-f", fa, "-o", cpu_prefix, "-p",
                    "hifi-masseq", "-t", THREADS], {"JAX_PLATFORMS": "cpu"},
                   cpu_prefix + ".log")
    say(f"  CPU-backend run (subprocess, JAX_PLATFORMS=cpu): "
        f"{time.perf_counter() - t0:.3f} s")
    check(read_bytes(cpu_prefix + ".vcf") == vcfs[1],
          "card VCF byte-identical to the CPU-backend VCF")
    check(hp_ps_tags(prefix + ".phased.bam")
          == hp_ps_tags(cpu_prefix + ".phased.bam"),
          "HP/PS tags identical to the CPU-backend run")
    acc = accuracy_metrics(prefix + ".vcf", params["truth"])
    say(f"  accuracy vs planted truth: precision {acc['acc_precision']}, "
        f"recall {acc['acc_recall']}, switch errors "
        f"{acc['acc_switch_errors']}/{acc['acc_switch_pairs']}")
    check(acc["acc_recall"] > 0.9 and acc["acc_precision"] > 0.9,
          "calls recover the planted hets")


def phase_stream(genome):
    say("== genome workload: --stream vs resident vs the CPU backend")
    bam, fa, params = genome
    out = {}
    for mode, extra in (("stream", ["--stream"]), ("resident", [])):
        prefix = os.path.join(DATA, f"genome_{mode}")
        t0 = time.perf_counter()
        cli(["-b", bam, "-f", fa, "-o", prefix, "-p", "hifi-masseq",
             "-t", THREADS] + extra)
        say(f"  {mode}: {params['n_reads']} reads in "
            f"{time.perf_counter() - t0:.3f} s")
        out[mode] = read_bytes(prefix + ".vcf")
    check(out["stream"] == out["resident"],
          "--stream VCF byte-identical to the resident run")
    cpu_prefix = os.path.join(DATA, "genome_cpu")
    t0 = time.perf_counter()
    cli_subprocess(["-b", bam, "-f", fa, "-o", cpu_prefix, "-p",
                    "hifi-masseq", "-t", THREADS], {"JAX_PLATFORMS": "cpu"},
                   cpu_prefix + ".log")
    say(f"  CPU-backend run (subprocess): {time.perf_counter() - t0:.3f} s")
    check(read_bytes(cpu_prefix + ".vcf") == out["resident"],
          "card VCF byte-identical to the CPU-backend VCF")


def one_card():
    require_gpus(1)
    phase_gpu_tests()
    dev = phase_device()
    import jax  # noqa: F401  (backend initialised by phase_device)

    from longcallr_tpu.config import preset

    os.makedirs(DATA, exist_ok=True)
    cfg = preset("hifi-masseq").replace(threads=int(THREADS))
    deep = deep_workload()
    genome = genome_workload()
    deep_prepared = prepared_regions(deep[0], deep[1], cfg)
    phase_kernels(deep_prepared, cfg)
    phase_candidates(genome, cfg)
    phase_deep(deep, cfg)
    phase_stream(genome)
    return dev


# -------------------------------------------------------------- four cards

def phase_pod(deep):
    from longcallr_tpu.parallel.multihost import host_gpu_count
    say("== 4-process pod through the CLI, one card per process")
    say(f"  cards on this host (nvidia-smi -L): {host_gpu_count()}")
    bam, fa, params = deep
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    prefix = os.path.join(DATA, "pod4")
    code = ("import sys; from longcallr_tpu.cli import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_VISIBLE_DEVICES", "JAX_LOCAL_DEVICE_IDS")}
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for pid in range(4):
            logs.append(open(os.path.join(DATA, f"pod4_{pid}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, "-b", bam, "-f", fa, "-o",
                 prefix, "-p", "hifi-masseq", "-t", THREADS,
                 "--coordinator", f"localhost:{port}", "--num-processes",
                 "4", "--process-id", str(pid), "--log-level", "WARNING"],
                cwd=HERE, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = [open(os.path.join(DATA, f"pod4_{i}.log")).read()[-1500:]
                 for i in range(4)]
        raise RuntimeError(f"pod rcs {rcs}: {tails}")
    say(f"  pod: {params['n_reads']} reads in "
        f"{time.perf_counter() - t0:.3f} s (process start included)")
    return prefix


def phase_pod_compare(deep, pod_prefix):
    bam, fa, _ = deep
    prefix = os.path.join(DATA, "pod1")
    t0 = time.perf_counter()
    cli(["-b", bam, "-f", fa, "-o", prefix, "-p", "hifi-masseq",
         "-t", THREADS])
    say(f"  one process: {time.perf_counter() - t0:.3f} s")
    check(read_bytes(pod_prefix + ".vcf") == read_bytes(prefix + ".vcf"),
          "4-process pod VCF byte-identical to one process")
    check(hp_ps_tags(pod_prefix + ".phased.bam")
          == hp_ps_tags(prefix + ".phased.bam"),
          "4-process pod HP/PS tags identical to one process")


def phase_mesh(deep, cfg):
    import jax

    from longcallr_tpu.parallel.mesh import make_mesh
    from longcallr_tpu.pipeline.caller import run

    say("== deep workload over a (regions=4, reads=1) mesh")
    bam, fa, _ = deep
    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    outs = {}
    for tag, m in (("mesh", mesh), ("single", None)):
        prefix = os.path.join(DATA, f"deep_{tag}")
        run(bam, fa, prefix, cfg, batched=True, mesh=m)       # warm
        before = stage_snapshot()
        t0 = time.perf_counter()
        run(bam, fa, prefix, cfg, batched=True, mesh=m)
        say(f"  {tag}: warm wall {time.perf_counter() - t0:.3f} s; "
            f"STAGE_TOTALS {json.dumps(stage_delta(before))}")
        outs[tag] = (read_bytes(prefix + ".vcf"),
                     hp_ps_tags(prefix + ".phased.bam"))
    check(outs["mesh"] == outs["single"],
          "mesh run's VCF and HP/PS tags identical to mesh=None")


def phase_giant(cfg):
    import jax
    import numpy as np

    from longcallr_tpu.parallel.giant import GIANT_CELLS, phase_region_sharded
    from longcallr_tpu.phasing.optimize import _bucket
    from longcallr_tpu.utils.bench_workload import make_deep_workload

    say("== giant locus, reads sharded over four cards")
    bam = os.path.join(DATA, "giant.bam")
    fa = os.path.join(DATA, "giant.fa")
    params = make_deep_workload(bam, fa, **GIANT)
    say(f"  {params['n_reads']} reads, {params['n_snps']} planted hets")
    prefix = os.path.join(DATA, "giant4")
    before = stage_snapshot()
    t0 = time.perf_counter()
    cli(["-b", bam, "-f", fa, "-o", prefix, "-p", "hifi-masseq",
         "-t", THREADS])
    st = stage_delta(before)
    say(f"  CLI on four cards: {time.perf_counter() - t0:.3f} s; "
        f"STAGE_TOTALS {json.dumps(st)}")
    check(st.get("phase_giant_sharded", 0) >= 1,
          "the locus took the reads-sharded path")

    (region, cands, frags, ds), = [
        x for x in prepared_regions(bam, fa, cfg)
        if x[2].p.shape[1] > cfg.max_enum_snps]
    cells = _bucket(frags.p.shape[0]) * _bucket(frags.p.shape[1])
    check(cells >= GIANT_CELLS, f"{cells} padded cells >= {GIANT_CELLS}")
    states = {}
    for n in (4, 1):
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("reads",))
        t0 = time.perf_counter()
        states[n] = [np.asarray(a) for a in phase_region_sharded(
            frags, cands, cfg, region.start, ds, mesh)]
        say(f"  phase_region_sharded on {n} card(s): "
            f"{time.perf_counter() - t0:.3f} s")
    for a, b, n in zip(states[4], states[1], ("sigma", "delta", "eta")):
        check(np.array_equal(a, b), f"giant {n}: four cards == one card")


def four_cards():
    require_gpus(4)
    say(f"nvidia-smi: {nvidia_smi()}")
    from longcallr_tpu.config import preset
    os.makedirs(DATA, exist_ok=True)
    cfg = preset("hifi-masseq").replace(threads=int(THREADS))
    deep = deep_workload()
    pod_prefix = phase_pod(deep)         # this process holds no card yet
    import jax
    dev = jax.devices()[0]
    check(dev.platform == "gpu" and len(jax.devices()) == 4,
          f"{len(jax.devices())} x {dev.device_kind}")
    phase_pod_compare(deep, pod_prefix)
    phase_mesh(deep, cfg)
    phase_giant(cfg)
    return dev


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card paths (pod, mesh, giant locus)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    dev = four_cards() if args.four else one_card()
    import jax
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
