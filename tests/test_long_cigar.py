"""CG-tag long-CIGAR support.

BAM stores CIGARs with more than 65,535 ops as a two-op ``kSmN``
placeholder (k = l_seq, m = reference span) plus the real cigar in a
``CG:B,I`` aux array (SAM spec 4.2.2). htslib — the reference's
rust-htslib substrate (Cargo.toml:13) — reconstructs this transparently,
so the reference binary pileups such reads correctly. These tests pin the
same behavior in io/bam.py (BamRead.cigar) and native/decode.cpp
(view_record → cg_substitute): a 66,000×1M CG-encoded read must produce
the exact same caller output as its inline single-op 66000M equivalent,
and raw passthrough must keep the original placeholder+CG bytes.
"""

import numpy as np

from longcallr_tpu.config import preset
from longcallr_tpu.io import bam as bamio
from longcallr_tpu.io.bam import BamFile
from longcallr_tpu.io.fasta import write_fasta
from longcallr_tpu.pipeline.caller import run
from tests.simulate import BASES, haplotype_seq, make_reference, plant_snps


def _make_pair(tmp_path, n_reads=40, span=66_000, L=70_000, seed=11):
    """Two BAMs with IDENTICAL reads: inline single-op (span)M cigars vs
    CG-encoded span×1M placeholders. Returns (inline_path, cg_path, fa)."""
    rng = np.random.default_rng(seed)
    ref = make_reference(rng, L)
    truth = plant_snps(rng, ref, n_het=12, n_hom=3, lo=2_000, hi=L - 2_000,
                       min_gap=400)
    haps = {1: haplotype_seq(truth, ref, 1), 2: haplotype_seq(truth, ref, 2)}
    reads = []
    for i in range(n_reads):
        hap = int(rng.integers(1, 3))
        pos = int(rng.integers(0, L - span))
        hseq = haps[hap][pos:pos + span].copy()
        errs = rng.random(span) < 0.002
        if errs.any():
            hseq[errs] = BASES[rng.integers(0, 4, size=int(errs.sum()))]
        quals = np.full(span, 30, dtype=np.uint8)
        tags = bamio.make_tag_bytes("de", "f", 0.001)
        tags += bamio.make_tag_bytes("ts", "A", "+" if i % 2 == 0 else "-")
        reads.append((pos, f"lng{i:05d}", 16 if i % 2 else 0,
                      bytes(hseq), quals, tags))
    reads.sort(key=lambda t: t[0])

    inline_path = str(tmp_path / "inline.bam")
    cg_path = str(tmp_path / "cg.bam")
    fa = str(tmp_path / "inline.fa")
    write_fasta(fa, {"chrL": bytes(ref)})
    write_fasta(str(tmp_path / "cg.fa"), {"chrL": bytes(ref)})

    one_m = np.full(span, (1 << 4) | 0, dtype=np.uint32)     # span × 1M
    placeholder = np.array([(span << 4) | 4,                 # l_seq S
                            (span << 4) | 3], dtype=np.uint32)  # span N
    with bamio.BamWriter(inline_path, ["chrL"], [L]) as w:
        for pos, qname, flag, seq, quals, tags in reads:
            w.write_record(qname=qname, flag=flag, ref_id=0, pos=pos, mapq=60,
                           cigar=np.array([(span << 4) | 0], np.uint32),
                           seq=seq, qual=quals, tags=tags)
    with bamio.BamWriter(cg_path, ["chrL"], [L]) as w:
        for pos, qname, flag, seq, quals, tags in reads:
            w.write_record(qname=qname, flag=flag, ref_id=0, pos=pos, mapq=60,
                           cigar=placeholder, seq=seq, qual=quals,
                           tags=tags + bamio.make_tag_bytes("CG", "B,I", one_m))
    return inline_path, cg_path, fa


def test_cg_cigar_reconstruction(tmp_path):
    """BamRead.cigar substitutes the 66,000-op CG array (>uint16 op
    count), layout offsets stay raw, and ref_end/softclips are right."""
    inline_path, cg_path, _ = _make_pair(tmp_path, n_reads=3)
    ib, cb = BamFile(inline_path), BamFile(cg_path)
    assert cb.n_records == ib.n_records == 3
    for i in range(3):
        r_c, r_i = cb.read(i), ib.read(i)
        assert r_c.cigar.size == 66_000
        assert int(r_c.cigar_lens.sum()) == 66_000
        assert (r_c.cigar_ops == 0).all()
        assert r_c.reference_end() == r_i.reference_end()
        assert r_c.leading_softclips() == 0 and r_c.trailing_softclips() == 0
        np.testing.assert_array_equal(r_c.seq, r_i.seq)
        # the load-time ref_end column (native scan) used the placeholder's
        # mN span, which the spec guarantees equals the real span
        assert int(cb.ref_end[i]) == int(ib.ref_end[i])


def test_cg_cigar_native_equals_numpy(tmp_path):
    """decode.cpp's cg_substitute and BamRead.cigar must agree bit-exactly
    (the suite's standing native-vs-numpy discipline, tests/test_native.py)."""
    import pytest

    from longcallr_tpu import native
    from longcallr_tpu.phasing.fragments import get_fragments
    from longcallr_tpu.tiles.pileup import build_pileup
    from longcallr_tpu.tiles.regions import Region

    if not native.available():
        pytest.skip("native library unavailable")
    _, cg_path, _ = _make_pair(tmp_path, n_reads=24)
    bam = BamFile(cg_path)
    from longcallr_tpu.io.fasta import FastaFile
    ref = FastaFile(str(tmp_path / "cg.fa")).fetch("chrL")
    cfg = preset("hifi-masseq")
    region = Region("chrL", 1, 69_999)
    a = build_pileup(bam, region, ref, cfg, use_native=True)
    b = build_pileup(bam, region, ref, cfg, use_native=False)
    fields = [f for f in vars(a) if isinstance(getattr(a, f), np.ndarray)]
    assert "cnt" in fields and "s_err" in fields
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    from longcallr_tpu.ops.candidates import select_candidates
    cands = select_candidates(a, cfg)
    assert cands.n > 0       # the planted SNPs must surface as candidates
    fa_ = get_fragments(bam, region, cands, cfg, use_native=True)
    fb_ = get_fragments(bam, region, cands, cfg, use_native=False)
    np.testing.assert_array_equal(fa_.p, fb_.p)
    np.testing.assert_array_equal(fa_.baseq, fb_.baseq)


def test_cg_cigar_pipeline_matches_inline(tmp_path):
    """Full caller on 40 CG-encoded 66k-op reads == inline equivalent:
    identical VCF bytes and HP/PS tags; passthrough keeps placeholder+CG."""
    inline_path, cg_path, fa = _make_pair(tmp_path)
    cfg = preset("hifi-masseq").replace(threads=2)
    o_i = run(inline_path, fa, str(tmp_path / "oi"), cfg)
    o_c = run(cg_path, str(tmp_path / "cg.fa"), str(tmp_path / "oc"), cfg)
    assert o_i.n_records == o_c.n_records > 0
    with open(o_i.vcf_path) as a, open(o_c.vcf_path) as b:
        la = [l for l in a if not l.startswith("##reference")]
        lb = [l for l in b if not l.startswith("##reference")]
        assert la == lb
    bi, bc = BamFile(o_i.phased_bam_path), BamFile(o_c.phased_bam_path)
    assert bi.n_records == bc.n_records == o_i.n_reads_tagged
    t_i = {bi.read(k).qname: (bi.read(k).get_tag("HP"), bi.read(k).get_tag("PS"))
           for k in range(bi.n_records)}
    t_c = {bc.read(k).qname: (bc.read(k).get_tag("HP"), bc.read(k).get_tag("PS"))
           for k in range(bc.n_records)}
    assert t_i == t_c
    assert any(v[0] is not None for v in t_i.values())
    # raw passthrough: the phased records keep the placeholder + CG aux
    # (the htslib write-side round trip), and re-reading reconstructs
    r0 = bc.read(0)
    assert r0._n_cigar == 2
    assert r0.get_tag("CG") is not None
    assert r0.cigar.size == 66_000
