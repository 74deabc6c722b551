"""CLI smoke tests: preset resolution, --get-blocks, full run."""

import numpy as np

from longcallr_tpu.cli import build_parser, config_from_args, main

from simulate import make_reference, plant_snps, simulate_bam


def test_preset_resolution():
    args = build_parser().parse_args(
        ["-b", "x.bam", "-f", "x.fa", "-o", "out", "-p", "ont-cdna",
         "--min-depth", "20"])
    cfg = config_from_args(args)
    assert cfg.platform == "ont"
    assert cfg.min_depth == 20          # explicit override wins
    assert cfg.min_phase_score == 13.0  # preset default
    assert cfg.strand_bias is True


def test_cli_get_blocks_and_run(tmp_path, rng, capsys):
    ref = make_reference(rng, 5000)
    truth = plant_snps(rng, ref, n_het=5, n_hom=1)
    bam_path = str(tmp_path / "c.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=40, read_len=2500,
                 err_rate=0.01)
    fa = bam_path.replace(".bam", ".fa")
    rc = main(["-b", bam_path, "-f", fa, "-o", str(tmp_path / "o"),
               "-p", "hifi-masseq", "--min-read-length", "100",
               "--get-blocks"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "chrS:" in out
    rc = main(["-b", bam_path, "-f", fa, "-o", str(tmp_path / "o"),
               "-p", "hifi-masseq", "--min-read-length", "100"])
    assert rc == 0
    assert (tmp_path / "o.vcf").exists()
    assert (tmp_path / "o.phased.bam").exists()


def test_cli_config_resolution():
    """Flag → CallerConfig resolution: presets, overrides, tri-states."""
    from longcallr_tpu.cli import build_parser, config_from_args

    parse = lambda extra: build_parser().parse_args(
        ["-b", "x.bam", "-f", "x.fa", "-o", "out", "-p", "ont-cdna"] + extra)
    a = parse([])
    cfg = config_from_args(a)
    assert cfg.min_depth == 10 and cfg.min_phase_score == 13.0
    assert cfg.strand_bias is True and cfg.is_ont
    assert a.batched is None                     # auto (multi-region only)
    assert cfg.somatic is False

    a2 = parse(["--somatic", "--somatic-purity", "0.42", "-t", "7",
                "--min-depth", "3", "--no-batched",
                "--bam-compression-level", "1"])
    cfg2 = config_from_args(a2)
    assert cfg2.somatic and abs(cfg2.somatic_purity - 0.42) < 1e-12
    assert cfg2.threads == 7 and cfg2.min_depth == 3
    assert cfg2.bam_compression_level == 1
    assert a2.batched is False

    a3 = parse(["--batched"])
    assert a3.batched is True


def test_cli_profile_dir_and_index_output(tmp_path, rng):
    """--profile-dir writes a jax.profiler trace; --index-output writes a
    .bai for the phased BAM."""
    import os

    ref = make_reference(rng, 5000)
    truth = plant_snps(rng, ref, n_het=5, n_hom=1)
    bam_path = str(tmp_path / "p.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=40, read_len=2500,
                 err_rate=0.01)
    fa = bam_path.replace(".bam", ".fa")
    prof = str(tmp_path / "trace")
    rc = main(["-b", bam_path, "-f", fa, "-o", str(tmp_path / "o"),
               "-p", "hifi-masseq", "--min-read-length", "100",
               "--profile-dir", prof, "--index-output"])
    assert rc == 0
    dumped = [os.path.join(r, f) for r, _, fs in os.walk(prof) for f in fs]
    assert dumped, "profiler trace directory is empty"
    assert (tmp_path / "o.phased.bam.bai").exists()
    # the written index is loadable and covers the contig
    from longcallr_tpu.io.bai import BaiIndex
    idx = BaiIndex.load(str(tmp_path / "o.phased.bam.bai"))
    assert len(idx.bins) >= 1


def test_cli_auto_stream(tmp_path, rng, monkeypatch, caplog):
    """AUTO stream: an indexed BAM above LONGCALLR_STREAM_AUTO_MB runs the
    streaming pipeline by default; --no-stream forces resident. Outputs are
    byte-identical either way (tests/test_stream_genome.py)."""
    from longcallr_tpu.io.bai import build_bai

    ref = make_reference(rng, 6000)
    truth = plant_snps(rng, ref, n_het=6, n_hom=1, min_gap=700)
    bam_path = str(tmp_path / "auto.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=50, read_len=2500,
                 err_rate=0.01)
    build_bai(bam_path)
    fa = bam_path.replace(".bam", ".fa")
    monkeypatch.setenv("LONGCALLR_STREAM_AUTO_MB", "0.001")
    import logging
    with caplog.at_level(logging.INFO):
        rc = main(["-b", bam_path, "-f", fa, "-o", str(tmp_path / "s"),
                   "-p", "hifi-masseq", "--min-read-length", "100"])
    assert rc == 0
    assert any("using --stream" in r.message for r in caplog.records)
    rc = main(["-b", bam_path, "-f", fa, "-o", str(tmp_path / "r"),
               "-p", "hifi-masseq", "--min-read-length", "100",
               "--no-stream"])
    assert rc == 0
    with open(str(tmp_path / "s.vcf")) as f1, open(str(tmp_path / "r.vcf")) as f2:
        assert f1.read() == f2.read()
    # without a .bai the auto heuristic stays resident
    import os as _os
    _os.remove(bam_path + ".bai")
    rc = main(["-b", bam_path, "-f", fa, "-o", str(tmp_path / "r2"),
               "-p", "hifi-masseq", "--min-read-length", "100"])
    assert rc == 0


def test_cli_pod_flag_validation(capsys):
    """--coordinator/--num-processes/--process-id must be given together."""
    rc = main(["-b", "x.bam", "-f", "x.fa", "-o", "o", "-p", "hifi-masseq",
               "--coordinator", "localhost:1234"])
    assert rc == 2
    assert "must be given together" in capsys.readouterr().err


def test_cli_two_process_pod(tmp_path, rng):
    """A REAL 2-process pod launched purely through the console entry point
    (python -m longcallr_tpu.cli --coordinator ... --num-processes 2
    --process-id N): process 0's serialized outputs equal a single-process
    run byte-for-byte."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from longcallr_tpu.config import preset
    from longcallr_tpu.pipeline.caller import run

    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=8, n_hom=1, min_gap=500)
    bam_path = str(tmp_path / "clip.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=60, read_len=2500,
                 err_rate=0.01)
    fa = bam_path.replace(".bam", ".fa")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_ENABLE_X64="1")
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    # --platform cpu: pin the CPU backend whatever JAX_PLATFORMS says (the
    # flag uses jax.config.update, which must precede
    # jax.distributed.initialize)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "longcallr_tpu.cli",
         "-b", bam_path, "-f", fa, "-o", str(tmp_path / "podcli"),
         "-p", "hifi-masseq", "--min-read-length", "100",
         "--platform", "cpu",
         "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(pid)],
        cwd=repo_root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    summary0 = json.loads(outs[0][0].splitlines()[-1])
    summary1 = json.loads(outs[1][0].splitlines()[-1])
    assert summary0["process"] == 0 and summary0["vcf_path"]
    assert summary1["process"] == 1
    single = run(bam_path, fa, str(tmp_path / "single"), cfg)
    with open(str(tmp_path / "podcli.vcf")) as f:
        pod_vcf = f.read()
    with open(single.vcf_path) as f:
        assert pod_vcf == f.read()
