"""End-to-end caller: simulated BAM+FASTA → VCF + phased BAM, checked
against simulation truth."""

import numpy as np
import pytest

from longcallr_tpu.config import preset
from longcallr_tpu.io.bam import BamFile
from longcallr_tpu.pipeline.caller import run

from simulate import make_reference, plant_snps, simulate_bam


def _parse_vcf(path):
    recs = []
    for line in open(path):
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        sample = dict(zip(f[8].split(":"), f[9].split(":")))
        recs.append(dict(chrom=f[0], pos=int(f[1]), ref=f[3], alt=f[4],
                         qual=int(f[5]), filter=f[6], info=f[7], sample=sample))
    return recs


def test_end_to_end_simulated(tmp_path, rng):
    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=2)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=14, n_hom=3, min_gap=420)
    bam_path = str(tmp_path / "sim.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=90, read_len=4000,
                 err_rate=0.01)
    out = run(bam_path, bam_path.replace(".bam", ".fa"), str(tmp_path / "out"), cfg)
    recs = _parse_vcf(out.vcf_path)
    assert out.n_records == len(recs)
    by_pos = {r["pos"] - 1: r for r in recs}

    # planted het SNPs: recovered as phased PASS hets
    phased_ok = 0
    haps = []
    for p, (refb, altb) in truth.het_snps.items():
        r = by_pos.get(p)
        if r is None:
            continue
        assert r["ref"] == chr(refb)
        if r["sample"]["GT"] in ("0|1", "1|0") and r["filter"] == "PASS":
            assert r["alt"] == chr(altb)
            phased_ok += 1
            haps.append(r["sample"]["GT"])
            assert r["sample"]["PS"] != "."
            assert float(r["sample"]["PQ"]) >= cfg.min_phase_score
    assert phased_ok >= len(truth.het_snps) * 0.7, (phased_ok, len(truth.het_snps))
    # phase consistency: all het sites should agree (hap1 always carries alt)
    assert len(set(haps)) == 1, haps

    # planted hom SNPs appear as 1/1
    hom_ok = 0
    for p, (refb, altb) in truth.hom_snps.items():
        r = by_pos.get(p)
        if r and r["sample"]["GT"] == "1/1":
            hom_ok += 1
    assert hom_ok >= len(truth.hom_snps) - 1

    # false positives: PASS-phased records at non-planted positions
    planted = set(truth.het_snps) | set(truth.hom_snps)
    fp = [r for r in recs
          if r["pos"] - 1 not in planted and r["filter"] == "PASS"
          and r["sample"]["GT"] in ("0|1", "1|0")]
    assert len(fp) <= 2, fp

    # phased BAM: HP tags consistent with truth haplotypes
    pb = BamFile(out.phased_bam_path)
    n_hp = 0
    agree = 0
    for r in pb:
        hp = r.get_tag("HP")
        if hp is None:
            continue
        n_hp += 1
        agree += int(hp == truth.hap_of_read[r.qname])
    assert n_hp >= 40
    frac = agree / n_hp
    assert frac > 0.9 or frac < 0.1, frac  # consistent up to global flip
    # reads with HP also carry PS
    for r in pb:
        if r.get_tag("HP") is not None:
            assert r.get_tag("PS") is not None
            break


def test_end_to_end_no_bam_output(tmp_path, rng):
    cfg = preset("hifi-masseq").replace(min_read_length=100,
                                        no_bam_output=True)
    ref = make_reference(rng, 4000)
    truth = plant_snps(rng, ref, n_het=4, n_hom=1)
    bam_path = str(tmp_path / "s2.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=40, read_len=2000,
                 err_rate=0.01)
    out = run(bam_path, bam_path.replace(".bam", ".fa"), str(tmp_path / "o2"), cfg)
    assert out.phased_bam_path is None
    assert out.n_records > 0


def test_end_to_end_input_vcf(tmp_path, rng):
    """-v mode: candidates imported from a VCF skip discovery."""
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 6000)
    truth = plant_snps(rng, ref, n_het=6, n_hom=1, min_gap=600)
    bam_path = str(tmp_path / "s3.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=60, read_len=3000,
                 err_rate=0.01)
    vcf_in = str(tmp_path / "in.vcf")
    with open(vcf_in, "w") as f:
        f.write("##fileformat=VCFv4.3\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        for p, (refb, altb) in sorted(truth.het_snps.items()):
            f.write(f"chrS\t{p+1}\t.\t{chr(refb)}\t{chr(altb)}\t60\tPASS\t.\tGT\t0/1\n")
    out = run(bam_path, bam_path.replace(".bam", ".fa"), str(tmp_path / "o3"),
              cfg, input_vcf=vcf_in)
    recs = _parse_vcf(out.vcf_path)
    got_pos = {r["pos"] - 1 for r in recs}
    assert got_pos == set(truth.het_snps)  # exactly the imported sites
    phased = [r for r in recs if r["sample"]["GT"] in ("0|1", "1|0")]
    assert len(phased) >= len(truth.het_snps) * 0.7


def test_resume_checkpoint(tmp_path, rng):
    """A resumed run skips completed regions and produces identical output."""
    import os
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 5000)
    truth = plant_snps(rng, ref, n_het=5, n_hom=1)
    bam_path = str(tmp_path / "r.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=40, read_len=2500,
                 err_rate=0.01)
    fa = bam_path.replace(".bam", ".fa")
    out1 = run(bam_path, fa, str(tmp_path / "o1"), cfg, resume=True)
    assert os.path.exists(str(tmp_path / "o1.regions.ckpt"))
    vcf1 = open(out1.vcf_path).read()
    # second run with the checkpoint present: all regions skipped
    out2 = run(bam_path, fa, str(tmp_path / "o1"), cfg, resume=True)
    vcf2 = open(out2.vcf_path).read()
    assert vcf1 == vcf2
    assert out2.n_records == out1.n_records


def test_resume_discards_stale_config(tmp_path, rng):
    """--resume under a changed configuration discards the checkpoint
    instead of silently reusing results computed under the old config
    (checkpoint stores a config-key header)."""
    import json
    import os
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 5000)
    truth = plant_snps(rng, ref, n_het=5, n_hom=1)
    bam_path = str(tmp_path / "s.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=40, read_len=2500,
                 err_rate=0.01)
    fa = bam_path.replace(".bam", ".fa")
    run(bam_path, fa, str(tmp_path / "s1"), cfg, resume=True)
    ckpt = str(tmp_path / "s1.regions.ckpt")
    with open(ckpt) as f:
        header = json.loads(f.readline())
    assert "__config__" in header
    # different tunables -> checkpoint invalidated and rewritten
    cfg2 = cfg.replace(min_allele_freq=0.33)
    run(bam_path, fa, str(tmp_path / "s1"), cfg2, resume=True)
    with open(ckpt) as f:
        header2 = json.loads(f.readline())
        body = f.read().splitlines()
    assert header2["__config__"] != header["__config__"]
    assert body  # regions recomputed and re-stored under the new key
    # same config again -> reused (file not regrown)
    size = os.path.getsize(ckpt)
    run(bam_path, fa, str(tmp_path / "s1"), cfg2, resume=True)
    assert os.path.getsize(ckpt) == size


def test_resume_empty_checkpoint_file(tmp_path):
    """A checkpoint file that exists but holds no parseable line (crash
    between create and header write) is treated as fresh: the __config__
    header is written before any result, so the next resume keeps the
    results instead of discarding them as headerless (round-2 advisor)."""
    from longcallr_tpu.pipeline.engine import RegionResult
    from longcallr_tpu.pipeline.resume import RegionCheckpoint
    from longcallr_tpu.tiles.regions import Region

    path = str(tmp_path / "e.ckpt")
    open(path, "w").close()                 # 0-byte survivor of a crash
    ck = RegionCheckpoint(path, key="k1")
    reg = Region(chr="chr1", start=1, end=100)
    ck.put(RegionResult(reg, ["chr1\t5\t.\tA\tC"], {}, {}, 3, 1))
    ck.close()
    ck2 = RegionCheckpoint(path, key="k1")
    assert ck2.n_done == 1
    assert ck2.get(reg) is not None
    ck2.close()
    # a file holding only a torn (unparseable) tail is also fresh
    with open(path, "w") as f:
        f.write('{"chr": "chr1", "sta')
    ck3 = RegionCheckpoint(path, key="k1")
    assert ck3.n_done == 0
    ck3.put(RegionResult(reg, [], {}, {}, 0, 0))
    ck3.close()
    ck4 = RegionCheckpoint(path, key="k1")
    assert ck4.n_done == 1
    ck4.close()


def test_batched_pipeline_quality(tmp_path, rng):
    """The batched multi-region pipeline recovers truth like the per-region
    path (RNG streams differ, so compare against truth not bytes)."""
    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=2)
    # two separate loci → two regions, each with enough SNPs for the
    # iterative path (>10 candidates)
    ref = make_reference(rng, 22000)
    truth = plant_snps(rng, ref, n_het=13, n_hom=0, lo=600, hi=8500, min_gap=560)
    t2 = plant_snps(rng, ref, n_het=13, n_hom=0, lo=13000, hi=21000, min_gap=560)
    truth.het_snps.update(t2.het_snps)
    bam_path = str(tmp_path / "b.bam")
    from longcallr_tpu.io import bam as bamio
    from simulate import haplotype_seq, BASES
    rows = []
    n = 0
    for locus in [(0, 9000), (12500, 21800)]:
        for i in range(70):
            hap = int(rng.integers(1, 3))
            pos = int(rng.integers(locus[0], locus[1] - 5000))
            span = 4800
            hseq = haplotype_seq(truth, ref, hap)[pos:pos + span].copy()
            errs = rng.random(span) < 0.01
            hseq[errs] = BASES[rng.integers(0, 4, size=int(errs.sum()))]
            qn = f"b{n:04d}"
            n += 1
            truth.hap_of_read[qn] = hap
            rows.append((pos, qn, hseq))
    rows.sort(key=lambda t: t[0])
    with bamio.BamWriter(bam_path, ["chrS"], [len(ref)]) as w:
        for pos, qn, seq in rows:
            w.write_record(qname=qn, flag=0, ref_id=0, pos=pos, mapq=60,
                           cigar=bamio.encode_cigar([(len(seq), "M")]),
                           seq=bytes(seq), qual=np.full(len(seq), 30),
                           tags=bamio.make_tag_bytes("de", "f", 0.001))
    from longcallr_tpu.io.fasta import write_fasta
    write_fasta(bam_path.replace(".bam", ".fa"), {"chrS": bytes(ref)})
    fa = bam_path.replace(".bam", ".fa")
    out = run(bam_path, fa, str(tmp_path / "ob"), cfg, batched=True)
    assert out.n_regions == 2
    recs = _parse_vcf(out.vcf_path)
    by_pos = {r["pos"] - 1: r for r in recs}
    phased = 0
    for p in truth.het_snps:
        r = by_pos.get(p)
        if r and r["sample"]["GT"] in ("0|1", "1|0") and r["filter"] == "PASS":
            phased += 1
    assert phased >= len(truth.het_snps) * 0.7, (phased, len(truth.het_snps))
    # phased BAM agreement with truth per haplotype (up to per-region flip)
    pb = BamFile(out.phased_bam_path)
    per_ps = {}
    for r in pb:
        hp = r.get_tag("HP")
        ps = r.get_tag("PS")
        if hp is None or ps is None:
            continue
        per_ps.setdefault(ps, []).append((truth.hap_of_read[r.qname], hp))
    assert len(per_ps) >= 2
    for ps, pairs in per_ps.items():
        agree = np.mean([t == h for t, h in pairs])
        assert agree > 0.9 or agree < 0.1, (ps, agree)


def test_downsample_path(tmp_path, rng):
    """--downsample: deep region downsampled to downsample_depth fragments,
    output still phases correctly."""
    cfg = preset("hifi-masseq").replace(min_read_length=100, downsample=True,
                                        downsample_depth=60)
    ref = make_reference(rng, 6000)
    truth = plant_snps(rng, ref, n_het=8, n_hom=0, min_gap=500)
    bam_path = str(tmp_path / "ds.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=120, read_len=3000,
                 err_rate=0.01)
    out = run(bam_path, bam_path.replace(".bam", ".fa"), str(tmp_path / "od"), cfg)
    recs = _parse_vcf(out.vcf_path)
    phased = [r for r in recs if r["sample"].get("GT") in ("0|1", "1|0")]
    assert len(phased) >= 4


def test_contigs_selection(tmp_path, rng):
    """-x contig filter restricts discovery to the named contigs."""
    from longcallr_tpu.io import bam as bamio
    from longcallr_tpu.io.fasta import write_fasta
    ref_a = make_reference(rng, 3000)
    ref_b = make_reference(rng, 3000)
    bam_path = str(tmp_path / "x.bam")
    with bamio.BamWriter(bam_path, ["cA", "cB"], [3000, 3000]) as w:
        for rid, ref in ((0, ref_a), (1, ref_b)):
            for i in range(8):
                w.write_record(qname=f"x{rid}_{i}", flag=0, ref_id=rid,
                               pos=100, mapq=60,
                               cigar=bamio.encode_cigar([(2000, "M")]),
                               seq=bytes(ref[100:2100]),
                               qual=np.full(2000, 30))
    write_fasta(str(tmp_path / "x.fa"), {"cA": bytes(ref_a), "cB": bytes(ref_b)})
    out = run(bam_path, str(tmp_path / "x.fa"), str(tmp_path / "ox"),
              preset("hifi-masseq").replace(min_read_length=100),
              contigs=["cB"])
    assert out.n_regions == 1
    for line in open(out.vcf_path):
        if not line.startswith("#"):
            assert line.startswith("cB\t")


def test_region_arg(tmp_path, rng):
    """-r chr:start-end processes exactly that window."""
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 6000)
    truth = plant_snps(rng, ref, n_het=6, n_hom=0, min_gap=700)
    bam_path = str(tmp_path / "rg.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=50, read_len=3000,
                 err_rate=0.01)
    out = run(bam_path, bam_path.replace(".bam", ".fa"), str(tmp_path / "orr"),
              cfg, input_region="chrS:2000-4000")
    pos = [int(l.split("\t")[1]) for l in open(out.vcf_path)
           if not l.startswith("#")]
    assert pos and min(pos) >= 2000 and max(pos) < 4000


def test_determinism_double_execution(tmp_path, rng):
    """Same inputs → byte-identical VCF and phased BAM across two runs
    (the determinism harness of SURVEY.md §5; the reference itself is only
    reproducible on its deterministic paths due to unseeded thread_rng)."""
    import hashlib
    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=2)
    ref = make_reference(rng, 8000)
    truth = plant_snps(rng, ref, n_het=13, n_hom=2, min_gap=450)
    bam_path = str(tmp_path / "det.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=80, read_len=3500,
                 err_rate=0.01)
    fa = bam_path.replace(".bam", ".fa")
    h = []
    for i in range(2):
        out = run(bam_path, fa, str(tmp_path / f"d{i}"), cfg)
        h.append((hashlib.sha1(open(out.vcf_path, "rb").read()).hexdigest(),
                  hashlib.sha1(open(out.phased_bam_path, "rb").read()).hexdigest()))
    assert h[0] == h[1]
    # batched path is deterministic too
    h2 = []
    for i in range(2):
        out = run(bam_path, fa, str(tmp_path / f"db{i}"), cfg, batched=True)
        h2.append(hashlib.sha1(open(out.vcf_path, "rb").read()).hexdigest())
    assert h2[0] == h2[1]


def test_batched_enum_path(tmp_path, rng):
    """Multiple small (enumeration-path) regions batch into one program and
    still recover truth."""
    from longcallr_tpu.io import bam as bamio
    from longcallr_tpu.io.fasta import write_fasta
    from simulate import haplotype_seq, BASES, Truth

    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=2)
    L = 40000
    ref = make_reference(rng, L)
    truth = Truth(ref=bytes(ref))
    # 4 isolated loci, each with 4 het SNPs (enumeration path: 4 <= 10)
    loci = [(2000, 8000), (12000, 18000), (22000, 28000), (32000, 38000)]
    for (s, e) in loci:
        for j in range(4):
            pos = s + 1000 + j * 1000
            refb = int(ref[pos])
            altb = int(BASES[(list(BASES).index(refb) + 1) % 4])
            truth.het_snps[pos] = (refb, altb)
    haps = {1: haplotype_seq(truth, ref, 1), 2: haplotype_seq(truth, ref, 2)}
    rows = []
    n = 0
    for (s, e) in loci:
        for i in range(30):
            hap = int(rng.integers(1, 3))
            pos = int(rng.integers(s, s + 800))
            seq = haps[hap][pos:pos + 5000].copy()
            errs = rng.random(len(seq)) < 0.01
            seq[errs] = BASES[rng.integers(0, 4, size=int(errs.sum()))]
            qn = f"e{n:04d}"
            n += 1
            truth.hap_of_read[qn] = hap
            rows.append((pos, qn, seq))
    rows.sort(key=lambda t: t[0])
    bam_path = str(tmp_path / "en.bam")
    with bamio.BamWriter(bam_path, ["chrS"], [L]) as w:
        for pos, qn, seq in rows:
            w.write_record(qname=qn, flag=0, ref_id=0, pos=pos, mapq=60,
                           cigar=bamio.encode_cigar([(len(seq), "M")]),
                           seq=bytes(seq), qual=np.full(len(seq), 30),
                           tags=bamio.make_tag_bytes("de", "f", 0.001))
    write_fasta(bam_path.replace(".bam", ".fa"), {"chrS": bytes(ref)})
    out = run(bam_path, bam_path.replace(".bam", ".fa"), str(tmp_path / "oen"),
              cfg, batched=True)
    assert out.n_regions == 4
    recs = _parse_vcf(out.vcf_path)
    by_pos = {r["pos"] - 1: r for r in recs}
    phased = sum(1 for p in truth.het_snps
                 if by_pos.get(p, {}).get("sample", {}).get("GT") in ("0|1", "1|0"))
    assert phased >= len(truth.het_snps) * 0.75, (phased, len(truth.het_snps))
    # per-locus phase consistency vs truth (up to per-phase-set flip)
    pb = BamFile(out.phased_bam_path)
    per_ps = {}
    for r in pb:
        hp, psv = r.get_tag("HP"), r.get_tag("PS")
        if hp is None or psv is None:
            continue
        per_ps.setdefault(psv, []).append((truth.hap_of_read[r.qname], hp))
    assert len(per_ps) >= 3
    for psv, pairs in per_ps.items():
        agree = np.mean([t == h for t, h in pairs])
        assert agree > 0.9 or agree < 0.1, (psv, agree)


def test_batched_resume_wave_granularity(tmp_path, rng, monkeypatch):
    """The batched driver checkpoints per wave: a crash after wave 1 leaves
    its regions in the ckpt, and the resumed run completes identically."""
    from longcallr_tpu.io.fasta import write_fasta
    from longcallr_tpu.ops import candidates as C
    from longcallr_tpu.phasing import batch_driver as BD

    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=2)
    # two well-separated regions on one contig
    ref = make_reference(rng, 14000)
    t1 = plant_snps(rng, ref[:6000], n_het=5, n_hom=1)
    bam_path = str(tmp_path / "wg.bam")
    from longcallr_tpu.io import bam as bamio
    with bamio.BamWriter(bam_path, ["chrS"], [len(ref)]) as w:
        k = 0
        for base in (0, 8000):
            for _ in range(30):
                s = base + int(rng.integers(0, 1500))
                e = min(s + 2500, base + 5500)
                seq = bytearray(ref[s:e])
                for pos, (a, b) in t1.het_snps.items():
                    p = pos + base
                    if s <= p < e:
                        seq[p - s] = [a, b][k % 2]
                w.write_record(qname=f"r{k}", flag=0, ref_id=0, pos=s,
                               mapq=60, cigar=bamio.encode_cigar(
                                   [(len(seq), "M")]),
                               seq=bytes(seq),
                               qual=np.full(len(seq), 30, np.uint8),
                               tags=bamio.make_tag_bytes("de", "f", 0.001))
                k += 1
    fa = str(tmp_path / "wg.fa")
    write_fasta(fa, {"chrS": bytes(ref)})

    # one region per wave; crash inside the SECOND wave's phasing
    monkeypatch.setattr(C, "CAND_BATCH_COLS", 1)
    calls = {"n": 0}
    orig = BD.phase_regions_batched

    def boom(items, cfg_, mesh=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected crash")
        return orig(items, cfg_, mesh=mesh)

    monkeypatch.setattr(BD, "phase_regions_batched", boom)
    import longcallr_tpu.pipeline.caller as CL
    monkeypatch.setattr(CL, "phase_regions_batched", boom, raising=False)
    with pytest.raises(RuntimeError):
        run(bam_path, fa, str(tmp_path / "o1"), cfg, resume=True,
            batched=True)
    ck = (tmp_path / "o1.regions.ckpt")
    assert ck.exists() and ck.read_text().strip(), "wave 1 not checkpointed"

    monkeypatch.setattr(BD, "phase_regions_batched", orig)
    monkeypatch.setattr(CL, "phase_regions_batched", orig, raising=False)
    out = run(bam_path, fa, str(tmp_path / "o1"), cfg, resume=True,
              batched=True)
    fresh = run(bam_path, fa, str(tmp_path / "o2"), cfg, batched=True)
    assert out.n_regions == fresh.n_regions == 2
    assert open(out.vcf_path).read().replace("o1", "oX") \
        == open(fresh.vcf_path).read().replace("o2", "oX")


def test_demo_golden_records(demo_bam_path, tmp_path):
    """Golden regression gate on the REAL demo reads: the full pipeline's
    records must be byte-identical to tests/golden/demo_chr20_records.vcf
    (frozen from a verified run). Any silent drift in any stage's
    numerics, wiring or seeding trips this."""
    import os

    from longcallr_tpu.utils.demo import make_consensus_reference

    data_dir = os.path.join(os.path.dirname(__file__), "..", "data")
    os.makedirs(data_dir, exist_ok=True)
    ref_fa = os.path.join(data_dir, "demo_chr20_consensus.fa")
    make_consensus_reference(demo_bam_path, ref_fa)
    cfg = preset("hifi-masseq").replace(threads=2)
    out = run(demo_bam_path, ref_fa, str(tmp_path / "demo"), cfg)
    with open(out.vcf_path) as f:
        got = [l for l in f if not l.startswith("#")]
    golden = os.path.join(os.path.dirname(__file__), "golden",
                          "demo_chr20_records.vcf")
    with open(golden) as f:
        want = f.readlines()
    assert got == want

    # haplotagging golden: every read's HP/PS assignment, byte-frozen
    from longcallr_tpu.io.bam import BamFile
    pb = BamFile(out.phased_bam_path)
    rows = []
    for i in range(pb.n_records):
        r = pb.read(i)
        hp = r.get_tag("HP")
        if hp is not None:
            rows.append(f"{r.qname}\t{hp}\t{r.get_tag('PS')}")
    rows.sort()
    tags_golden = os.path.join(os.path.dirname(__file__), "golden",
                               "demo_chr20_tags.tsv")
    with open(tags_golden) as f:
        want_tags = f.read().splitlines()
    assert rows == want_tags


def test_wave_split_and_overlap_byte_identical(tmp_path, monkeypatch):
    """The work-aware wave split (LONGCALLR_WAVE_CELLS) and the
    double-buffered prepare (LONGCALLR_WAVE_OVERLAP) must not change a byte:
    wave/bucket composition only regroups regions, and every region's phasing
    consumes its own seed stream (phasing/batch_driver.py)."""
    from longcallr_tpu.phasing import batch_driver as bd
    from longcallr_tpu.utils.bench_workload import make_deep_workload

    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=2)
    bam_p = str(tmp_path / "wv.bam")
    fa_p = str(tmp_path / "wv.fa")
    make_deep_workload(bam_p, fa_p, n_regions=3, region_len=2400,
                       snp_spacing=120, coverage=30, read_len=600,
                       err_rate=0.0, gap=3000, seed=7, contig="chrW")

    calls = []
    orig = bd.phase_regions_batched

    def spy(items, *a, **kw):
        calls.append(len(items))
        return orig(items, *a, **kw)

    monkeypatch.setattr(bd, "phase_regions_batched", spy)

    def _run(tag):
        out = run(bam_p, fa_p, str(tmp_path / tag), cfg, batched=True)
        with open(out.vcf_path) as f:
            recs = [ln for ln in f if not ln.startswith("#")]
        pb = BamFile(out.phased_bam_path)
        tags = sorted((r.qname, r.get_tag("HP"), r.get_tag("PS")) for r in pb)
        return recs, tags

    base = _run("one_wave")             # default budget → one 3-region wave
    assert calls and max(calls) == 3
    calls.clear()
    monkeypatch.setenv("LONGCALLR_WAVE_CELLS", "1")
    split = _run("split")               # one region per wave, prepare ahead
    assert len(calls) == 3 and max(calls) == 1
    monkeypatch.setenv("LONGCALLR_WAVE_OVERLAP", "0")
    serial = _run("serial")             # same waves, serial prepare
    assert split == base
    assert serial == base


def test_vmem_bucket_split_byte_identical(tmp_path, monkeypatch):
    """Splitting a bucket into smaller dispatches (here the batch-axis cap,
    forced to one region per dispatch) must not change a byte — bucket
    composition only regroups regions (per-region seed streams)."""
    from longcallr_tpu.phasing import batch_driver as bd
    from longcallr_tpu.utils.bench_workload import make_deep_workload

    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=2)
    bam_p = str(tmp_path / "vm.bam")
    fa_p = str(tmp_path / "vm.fa")
    make_deep_workload(bam_p, fa_p, n_regions=3, region_len=2400,
                       snp_spacing=120, coverage=30, read_len=600,
                       err_rate=0.0, gap=3000, seed=9, contig="chrV")

    sizes = []
    orig = bd._phase_bucket

    def spy(group, *a, **kw):
        sizes.append(len(group))
        return orig(group, *a, **kw)

    monkeypatch.setattr(bd, "_phase_bucket", spy)

    def _run(tag):
        out = run(bam_p, fa_p, str(tmp_path / tag), cfg, batched=True)
        with open(out.vcf_path) as f:
            recs = [ln for ln in f if not ln.startswith("#")]
        pb = BamFile(out.phased_bam_path)
        tags = sorted((r.qname, r.get_tag("HP"), r.get_tag("PS")) for r in pb)
        return recs, tags

    base = _run("whole")                # under the cap → no split
    assert sizes and max(sizes) == 3
    sizes.clear()
    monkeypatch.setattr(bd, "CPU_BUCKET_B_CAP", 1)   # force max split
    split = _run("split")               # one region per bucket dispatch
    # sizes = [3 (outer cap call), 1, 1, 1 (recursive dispatches)]
    assert sizes.count(1) >= 3
    assert split == base


def test_finalize_pool_byte_identical(tmp_path, monkeypatch):
    """The deep-wave finalize fan-out (LONGCALLR_FINALIZE_MT_CELLS) must not
    change a byte: finalize_region is per-region independent (own rng
    stream seeded by region.start, own cell tables, thread-local T4 cache),
    so pooled vs serial execution differs only in scheduling."""
    from longcallr_tpu.utils.bench_workload import make_deep_workload

    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=3)
    bam_p = str(tmp_path / "fp.bam")
    fa_p = str(tmp_path / "fp.fa")
    make_deep_workload(bam_p, fa_p, n_regions=3, region_len=2400,
                       snp_spacing=120, coverage=30, read_len=600,
                       err_rate=0.0, gap=3000, seed=11, contig="chrF")

    def _run(tag):
        out = run(bam_p, fa_p, str(tmp_path / tag), cfg, batched=True)
        with open(out.vcf_path) as f:
            recs = [ln for ln in f if not ln.startswith("#")]
        pb = BamFile(out.phased_bam_path)
        tags = sorted((r.qname, r.get_tag("HP"), r.get_tag("PS")) for r in pb)
        return recs, tags

    monkeypatch.setenv("LONGCALLR_FINALIZE_MT_CELLS", str(1 << 60))
    serial = _run("fser")              # threshold unreachable → serial path
    monkeypatch.setenv("LONGCALLR_FINALIZE_MT_CELLS", "1")
    pooled = _run("fpool")             # every region "big" → thread pool
    assert pooled == serial


def test_ambient_jax_placement_propagates_to_workers():
    """jax.default_device contexts are thread-local; the wave prepare/phase
    pools and the pooled per-region map must re-enter the orchestrating
    thread's override or a CPU-placed run (e.g. bench.py's comparison leg)
    silently dispatches phasing to the default accelerator backend
    (caller.py::_ambient_jax_placement)."""
    import jax
    from concurrent.futures import ThreadPoolExecutor
    from longcallr_tpu.pipeline.caller import _ambient_jax_placement

    def seen_device():
        return jax.config.jax_default_device

    # no override active → fn returned unchanged (zero overhead)
    assert _ambient_jax_placement(seen_device) is seen_device

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        wrapped = _ambient_jax_placement(seen_device)
        with ThreadPoolExecutor(max_workers=1) as ex:
            assert ex.submit(seen_device).result() is None  # the leak
            assert ex.submit(wrapped).result() is cpu       # the fix
    # the wrapper captured at wrap time — still applies outside the context
    with ThreadPoolExecutor(max_workers=1) as ex:
        assert ex.submit(wrapped).result() is cpu
