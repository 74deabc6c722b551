#!/usr/bin/env python
"""Phasing-precision A/B on the deep workload, one arm per process.

Arms, each in its own device process through the CLI (one cold run, then
``--runs`` warm runs), in the order a, b, c, c, b:

  a  the parent tree given by ``--parent`` as it ships: auto mode, which
     takes the hi/lo f32 split on every non-CPU placement at default
     matmul precision (a GPU may run those contractions in TF32);
  b  this tree, auto mode with the split on the GPU
     (optimize.F32_AUTO_PLATFORMS = {"gpu"}): the split at HIGHEST, with the
     f64 safety net live (LONGCALLR_F32_KERNELS=1 would skip the net, which
     needs an exact placement to rerun on);
  c  this tree with LONGCALLR_F32_KERNELS=0: native f64 (no fused bucket
     program, host block flip, no safety net needed).

A CPU-backend process (JAX_PLATFORMS=cpu) of this tree gives the reference
VCF and HP/PS tags. Each arm reports its warm walls, the phase stage split,
the safety-net recompute count and how its outputs differ from the
reference. This process stays off the device: it only generates the input
and launches the arms.

Usage: python experiments/precision_arms.py --parent DIR [--runs 3]
       [--out FILE]
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# run inside each arm process: the CLI in-process, cold + warm runs, with
# the engine's stage totals per run
_ARM = r"""
import json, sys, time
tree, out_prefix, runs, threads, bam, fa, auto = sys.argv[1:8]
sys.path.insert(0, tree)
if auto:
    from longcallr_tpu.phasing import optimize
    optimize.F32_AUTO_PLATFORMS = frozenset(json.loads(auto))
from longcallr_tpu.cli import main
from longcallr_tpu.pipeline.engine import STAGE_TOTALS
import jax
res = {"platform": jax.devices()[0].platform, "runs": []}
for r in range(1 + int(runs)):
    STAGE_TOTALS.clear()
    t0 = time.perf_counter()
    rc = main(["-b", bam, "-f", fa, "-o", out_prefix, "-p", "hifi-masseq",
               "-t", threads, "--log-level", "WARNING"])
    wall = time.perf_counter() - t0
    assert rc == 0, rc
    res["runs"].append({"wall_s": wall, "stages": dict(STAGE_TOTALS)})
print("ARM_RESULT " + json.dumps(res), flush=True)
"""


def _records(vcf):
    with open(vcf) as f:
        return [ln for ln in f if not ln.startswith("#")]


def _tags(bam_path):
    from longcallr_tpu.io.bam import BamFile
    return sorted((r.qname, r.get_tag("HP"), r.get_tag("PS"))
                  for r in BamFile(bam_path))


def _launch(tree, out_prefix, runs, env_extra, bam, fa, log_path,
            auto_platforms=None):
    env = dict(os.environ)
    env.pop("LONGCALLR_F32_KERNELS", None)
    env.update(env_extra)
    threads = str(os.cpu_count() or 4)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        auto = "" if auto_platforms is None else json.dumps(auto_platforms)
        p = subprocess.run([sys.executable, "-c", _ARM, tree, out_prefix,
                            str(runs), threads, bam, fa, auto],
                           cwd=tree, env=env, stdout=subprocess.PIPE,
                           stderr=log, text=True, timeout=1800)
    if p.returncode != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"arm process rc={p.returncode}: {tail}")
    line = [ln for ln in p.stdout.splitlines()
            if ln.startswith("ARM_RESULT ")][-1]
    res = json.loads(line[len("ARM_RESULT "):])
    res["process_s"] = time.perf_counter() - t0
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="checkout of the parent commit (arm a)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from longcallr_tpu.utils.bench_workload import make_deep_workload

    data = os.path.join(HERE, "data")
    work = os.path.join(data, "arms")
    os.makedirs(work, exist_ok=True)
    bam = os.path.join(data, "deep_bench.bam")
    fa = os.path.join(data, "deep_bench.fa")
    make_deep_workload(bam, fa)
    parent = os.path.abspath(args.parent)

    out = {}
    ref_prefix = os.path.join(work, "cpu")
    out["cpu"] = _launch(HERE, ref_prefix, 0, {"JAX_PLATFORMS": "cpu"},
                         bam, fa, ref_prefix + ".log")
    print(json.dumps({"arm": "cpu", **out["cpu"]}), flush=True)
    ref_vcf = _records(ref_prefix + ".vcf")
    ref_tags = _tags(ref_prefix + ".phased.bam")
    arms = {"a": (parent, {}, None),
            "b": (HERE, {}, ["gpu"]),
            "c": (HERE, {"LONGCALLR_F32_KERNELS": "0"}, None)}
    for i, name in enumerate(("a", "b", "c", "c", "b")):
        tree, env, auto = arms[name]
        prefix = os.path.join(work, f"arm_{name}{i}")
        # arm a only shows the TF32 damage: one warm run is enough
        runs = 1 if name == "a" else args.runs
        res = _launch(tree, prefix, runs, env, bam, fa, prefix + ".log",
                      auto)
        recs = _records(prefix + ".vcf")
        warm = [r["wall_s"] for r in res["runs"][1:]]
        last = res["runs"][-1]["stages"]
        res.update(
            warm_walls_s=warm,
            warm_median_s=sorted(warm)[len(warm) // 2],
            phase_stages={k: v for k, v in last.items()
                          if k.startswith("phase")},
            vcf_identical_to_cpu=recs == ref_vcf,
            vcf_records=len(recs),
            vcf_records_differing=sum(a != b for a, b in zip(recs, ref_vcf))
            + abs(len(recs) - len(ref_vcf)),
            tags_identical_to_cpu=_tags(prefix + ".phased.bam") == ref_tags)
        del res["runs"]
        out[f"{name}{i}"] = res
        print(json.dumps({"arm": name, "order": i, **res}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
