"""Whole-genome --stream validation: a multi-contig
BAM with mixed region sizes including one deep "giant" locus must produce
byte-identical outputs through the per-contig streaming mode
(pipeline/caller.run_streaming) and the all-resident pipeline, and the
streaming windows must obey the one-contig memory contract at the IO layer
(BAI-windowed images, io/bam.py::_load_window)."""

import os

import numpy as np

from longcallr_tpu.config import preset
from longcallr_tpu.io.bam import BamFile
from longcallr_tpu.pipeline.caller import run, run_streaming
from longcallr_tpu.utils.bench_workload import make_genome_workload


def test_stream_equals_resident_multi_contig(tmp_path):
    """3 contigs, 7 loci (coverage 40-300, incl. one deep locus): stream ==
    resident VCF bytes and HP/PS tags; records span every contig."""
    bam_path = str(tmp_path / "genome.bam")
    fa_path = str(tmp_path / "genome.fa")
    params = make_genome_workload(bam_path, fa_path, contigs=[
        ("chrA", [(25_000, 40, 160), (15_000, 60, 200)]),
        ("chrB", [(20_000, 200, 200), (8_000, 50, 150)]),   # giant locus
        ("chrC", [(12_000, 40, 160), (12_000, 40, 300), (8_000, 80, 150)]),
    ])
    assert params["n_reads"] > 2_500
    cfg = preset("hifi-masseq").replace(threads=2)

    full = run(bam_path, fa_path, str(tmp_path / "full"), cfg)
    stream = run_streaming(bam_path, fa_path, str(tmp_path / "stream"), cfg)
    assert stream.n_records == full.n_records > 0

    with open(full.vcf_path) as f:
        v_full = f.read()
    with open(stream.vcf_path) as f:
        v_stream = f.read()
    assert v_full == v_stream
    chroms = {l.split("\t")[0] for l in v_full.splitlines()
              if not l.startswith("#")}
    assert chroms == {"chrA", "chrB", "chrC"}

    fb = BamFile(full.phased_bam_path)
    sb = BamFile(stream.phased_bam_path)
    assert fb.n_records == sb.n_records
    t_f = {fb.read(i).qname: (fb.read(i).get_tag("HP"),
                              fb.read(i).get_tag("PS"))
           for i in range(fb.n_records)}
    t_s = {sb.read(i).qname: (sb.read(i).get_tag("HP"),
                              sb.read(i).get_tag("PS"))
           for i in range(sb.n_records)}
    assert t_f == t_s

    # IO-layer memory contract: every per-contig BAI window decompresses
    # strictly less than the whole BAM, and windows partition the records
    whole = BamFile(bam_path)
    total = whole.n_records
    win_sum = 0
    for chrom, clen in (("chrA", 10**9), ("chrB", 10**9), ("chrC", 10**9)):
        win = BamFile(bam_path, region=(chrom, 0, clen))
        assert win.n_records < total
        win_sum += win.n_records
    assert win_sum == total

    # kill switch for the streaming overlap (window prefetch + background
    # deflate): the strictly-one-contig loop produces the same bytes,
    # including the BGZF container framing of the phased BAM
    import unittest.mock as _mock
    with _mock.patch.dict(os.environ, {"LONGCALLR_STREAM_PREFETCH": "0"}):
        plain = run_streaming(bam_path, fa_path, str(tmp_path / "plain"), cfg)
    with open(plain.vcf_path) as f:
        assert f.read() == v_stream
    with open(plain.phased_bam_path, "rb") as a, \
            open(stream.phased_bam_path, "rb") as b:
        assert a.read() == b.read()


def test_stream_resume_multi_contig(tmp_path):
    """--resume over the streaming mode: a rerun with the checkpoint present
    reuses completed regions and produces identical bytes."""
    bam_path = str(tmp_path / "genome.bam")
    fa_path = str(tmp_path / "genome.fa")
    make_genome_workload(bam_path, fa_path, contigs=[
        ("chrA", [(15_000, 40, 200)]),
        ("chrB", [(15_000, 60, 200)]),
    ])
    cfg = preset("hifi-masseq").replace(threads=2)
    first = run_streaming(bam_path, fa_path, str(tmp_path / "s"), cfg,
                          resume=True)
    assert os.path.exists(str(tmp_path / "s.regions.ckpt"))
    with open(first.vcf_path) as f:
        v1 = f.read()
    again = run_streaming(bam_path, fa_path, str(tmp_path / "s"), cfg,
                          resume=True)
    with open(again.vcf_path) as f:
        v2 = f.read()
    assert v1 == v2
