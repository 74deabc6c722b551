"""Overlapped resident-path phased-BAM write.

The batched ``run()`` path deflates each wave's phased records on an ordered
background writer while later waves compute (pipeline/caller.py::
_ResidentWriteOverlap). The output must be byte-identical to the strictly
serial end-of-run write (the reference's serial third pass,
thread.rs:307-361), including when

- waves are split small so several wave_done merges interleave with writes,
- the same qname occurs in more than one region (the first-wins hazard:
  a record's HP/PS can be determined by a *later* region's assignment map,
  so the writer must queue that region until the merge frontier passes the
  qname's last possible contributor).
"""

import os
import unittest.mock as mock

import numpy as np

from longcallr_tpu.config import preset
from longcallr_tpu.io.bam import BamFile, BamWriter
from longcallr_tpu.pipeline.caller import run
from longcallr_tpu.utils.bench_workload import make_genome_workload


def _run_pair(bam_path, fa_path, tmp_path, cfg, wave_cells=None):
    env_on = {"LONGCALLR_RESIDENT_WRITE_OVERLAP": "1"}
    env_off = {"LONGCALLR_RESIDENT_WRITE_OVERLAP": "0"}
    if wave_cells is not None:
        env_on["LONGCALLR_WAVE_CELLS"] = str(wave_cells)
        env_off["LONGCALLR_WAVE_CELLS"] = str(wave_cells)
    with mock.patch.dict(os.environ, env_on):
        o_ov = run(bam_path, fa_path, str(tmp_path / "ov"), cfg, batched=True)
    with mock.patch.dict(os.environ, env_off):
        o_ser = run(bam_path, fa_path, str(tmp_path / "ser"), cfg,
                    batched=True)
    with open(o_ov.vcf_path) as a, open(o_ser.vcf_path) as b:
        assert a.read() == b.read()
    with open(o_ov.phased_bam_path, "rb") as a, \
            open(o_ser.phased_bam_path, "rb") as b:
        assert a.read() == b.read()
    assert o_ov.n_reads_tagged == o_ser.n_reads_tagged > 0
    return o_ov


def test_overlap_write_multi_wave_byte_identical(tmp_path):
    """Multi-contig workload forced into many small waves: overlapped and
    serial writes produce identical BGZF bytes (container framing included)."""
    bam_path = str(tmp_path / "g.bam")
    fa_path = str(tmp_path / "g.fa")
    make_genome_workload(bam_path, fa_path, contigs=[
        ("chrA", [(12_000, 40, 120), (8_000, 50, 150)]),
        ("chrB", [(10_000, 60, 130), (6_000, 40, 120)]),
    ])
    cfg = preset("hifi-masseq").replace(threads=2)
    # tiny wave budget → one region per wave → maximal write/compute overlap
    _run_pair(bam_path, fa_path, tmp_path, cfg, wave_cells=1)


def test_overlap_write_resume_byte_identical(tmp_path):
    """Checkpointed regions enter the overlap writer as up-front preset
    pairs (no wave ever runs for them): a fully-resumed batched run must
    still produce byte-identical VCF + phased BAM."""
    bam_path = str(tmp_path / "g.bam")
    fa_path = str(tmp_path / "g.fa")
    make_genome_workload(bam_path, fa_path, contigs=[
        ("chrA", [(10_000, 40, 150), (8_000, 50, 150)]),
    ])
    cfg = preset("hifi-masseq").replace(threads=2)
    o1 = run(bam_path, fa_path, str(tmp_path / "r"), cfg, batched=True,
             resume=True)
    # second run: every region comes from the checkpoint
    o2 = run(bam_path, fa_path, str(tmp_path / "r"), cfg, batched=True,
             resume=True)
    assert o2.n_records == o1.n_records > 0
    assert o2.n_reads_tagged == o1.n_reads_tagged > 0
    with open(o1.phased_bam_path, "rb") as a:
        b1 = a.read()
    o3 = run(bam_path, fa_path, str(tmp_path / "r"), cfg, batched=True,
             resume=True)
    with open(o3.phased_bam_path, "rb") as a:
        assert a.read() == b1


def test_overlap_writer_queues_until_last_contributor(tmp_path):
    """White-box: a region whose record qname can still be tagged by a
    LATER region must not be written until the merge frontier passes that
    qname's last contributor — and the tag it then gets must be the later
    region's (global first-wins, thread.rs:309-325)."""
    from longcallr_tpu.pipeline.caller import _ResidentWriteOverlap
    from longcallr_tpu.pipeline.engine import RegionResult
    from longcallr_tpu.tiles.regions import Region

    src = str(tmp_path / "tiny.bam")
    seq = b"ACGT" * 25
    qual = np.full(100, 30, np.uint8)
    cig = np.array([(100 << 4) | 0], np.uint32)
    with BamWriter(src, ["chrA", "chrB"], [2000, 2000]) as w:
        for rid, qn in ((0, "aaaa"), (0, "dupq"), (1, "dupq"), (1, "bbbb")):
            w.write_record(qname=qn, flag=0, ref_id=rid, pos=100, mapq=60,
                           cigar=cig, seq=seq, qual=qual)
    bam = BamFile(src)
    regs = [Region("chrA", 1, 1999), Region("chrB", 1, 1999)]
    cfg = preset("hifi-masseq")
    out_path = str(tmp_path / "tagged.bam")
    ov = _ResidentWriteOverlap(bam, regs, [("chrA", 2000), ("chrB", 2000)],
                               out_path, cfg)
    ov._futs[0].result()          # prepass done
    # "dupq" has records on both contigs → its last contributor is the
    # chrB region (sorted index 1); unique names stay bounded by their own
    assert ov._cb["dupq"] == 1 and ov._cb["aaaa"] == 0
    # region 0 finalizes WITHOUT a dupq entry: the writer must hold it
    ov.wave_done([(0, RegionResult(regs[0], [], {"aaaa": 1}, {"aaaa": 7},
                                   0, 0))])
    ov._futs[-1].result()
    assert ov._F == 1 and ov._W == 0     # merged but queued (hazard)
    # region 1 provides dupq → frontier passes, both regions flush
    ov.wave_done([(1, RegionResult(regs[1], [], {"dupq": 2}, {"dupq": 9},
                                   0, 0))])
    ov._futs[-1].result()
    assert ov._W == 2
    n_tagged, _bg = ov.finish()
    assert n_tagged == 4
    got = BamFile(out_path)
    tags = {}
    for i in range(got.n_records):
        r = got.read(i)
        tags.setdefault(r.qname, []).append((r.get_tag("HP"), r.get_tag("PS")))
    # the chrA dupq record carries chrB's first-wins values
    assert tags["dupq"] == [(2, 9), (2, 9)]
    assert tags["aaaa"] == [(1, 7)] and tags["bbbb"] == [(None, None)]


def test_overlap_write_duplicate_qnames_hazard(tmp_path):
    """Same qname planted in regions on two contigs: the chrA region's
    records can be tagged by chrB's first-wins map entries, so the writer
    must hold chrA until chrB's maps merge. Bytes must still match the
    serial write exactly."""
    bam_path = str(tmp_path / "g.bam")
    fa_path = str(tmp_path / "g.fa")
    make_genome_workload(bam_path, fa_path, contigs=[
        ("chrA", [(10_000, 40, 120)]),
        ("chrB", [(10_000, 40, 120)]),
    ])
    src = BamFile(bam_path)
    # rename 8 chrB records' qnames to 8 chrA qnames (same byte length —
    # the simulator's names are fixed-width), creating cross-region
    # duplicates the way supplementary/mate records share names
    tb = src._ref_index["chrB"]
    ta = src._ref_index["chrA"]
    idx_b = np.nonzero(src.ref_id == tb)[0][:8]
    idx_a = np.nonzero(src.ref_id == ta)[0][:8]
    qn_a = src.qnames_at(idx_a)
    buf = bytearray(src._buf)
    for ridx, new_q in zip(idx_b, qn_a):
        off = int(src.rec_off[ridx])
        n = int(src.l_read_name[ridx])
        nb = new_q.encode() + b"\x00"
        assert len(nb) == n
        buf[off + 32:off + 32 + n] = nb
    hacked = str(tmp_path / "dup.bam")
    with BamWriter(hacked, src.references, src.lengths,
                   header_text=src.header_text) as w:
        for i in range(src.n_records):
            w.write_raw(bytes(buf[int(src.rec_off[i]):int(src.rec_end[i])]))
    # sanity: the duplicate names really exist on both contigs now
    chk = BamFile(hacked)
    assert set(chk.qnames_at(idx_b)) == set(qn_a)

    cfg = preset("hifi-masseq").replace(threads=2)
    _run_pair(hacked, fa_path, tmp_path, cfg, wave_cells=1)


def test_overlap_writer_aborts_on_vcf_write_failure(tmp_path):
    """Any failure between the region pipeline and ov.finish() — here the
    VCF write — must abort the background writer: pool stopped, fd closed,
    and the partial .phased.bam removed (the serial path would have
    produced no BAM at all)."""
    bam_path = str(tmp_path / "ab.bam")
    fa_path = str(tmp_path / "ab.fa")
    make_genome_workload(bam_path, fa_path, [("chrA", [(10_000, 40, 120)])])

    cfg = preset("hifi-masseq").replace(threads=2)
    boom = RuntimeError("disk full (simulated)")
    with mock.patch.dict(os.environ,
                         {"LONGCALLR_RESIDENT_WRITE_OVERLAP": "1"}):
        with mock.patch("longcallr_tpu.pipeline.caller.write_vcf_header",
                        side_effect=boom):
            import pytest
            with pytest.raises(RuntimeError, match="disk full"):
                run(bam_path, fa_path, str(tmp_path / "ab"), cfg,
                    batched=True)
    assert not os.path.exists(str(tmp_path / "ab.phased.bam"))
