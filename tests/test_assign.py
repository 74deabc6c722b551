"""Assignment layer vs scalar oracle transcriptions of snpfrags.rs."""

import copy

import numpy as np
import pytest

from longcallr_tpu.config import preset
from longcallr_tpu.io.bam import BamFile
from longcallr_tpu.ops.candidates import select_candidates
from longcallr_tpu.phasing import assign as A
from longcallr_tpu.phasing.fragments import get_fragments
from longcallr_tpu.phasing.kernels import make_cell_tables_np
from longcallr_tpu.phasing.optimize import phase_region
from longcallr_tpu.tiles.pileup import build_pileup
from longcallr_tpu.tiles.regions import Region

import oracle_assign as OA
from simulate import make_reference, plant_snps, simulate_bam


def _setup(tmp_path, rng, n_het=12):
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 8000)
    truth = plant_snps(rng, ref, n_het=n_het, n_hom=2, min_gap=500)
    path = str(tmp_path / "as.bam")
    simulate_bam(path, rng, ref, truth, n_reads=70, read_len=3500, err_rate=0.015)
    bam = BamFile(path)
    region = Region(chr="chrS", start=1, end=len(ref) + 1)
    pl = build_pileup(bam, region, ref, cfg)
    cands = select_candidates(pl, cfg)
    frags = get_fragments(bam, region, cands, cfg)
    st = phase_region(frags, cands, cfg, seed=1)
    frags.haplotag = np.sign(np.asarray(st.sigma)).astype(np.int8)
    cands.haplotype = np.sign(np.asarray(st.delta)).astype(np.int8)
    cands.genotype = np.asarray(st.eta).astype(np.int8)
    return cfg, cands, frags


def _clone(cands, frags):
    c = copy.deepcopy(cands)
    f = copy.deepcopy(frags)
    return c, f


def test_assign_reads_matches_oracle(tmp_path, rng):
    cfg, cands, frags = _setup(tmp_path, rng)
    c2, f2 = _clone(cands, frags)
    ct = make_cell_tables_np(frags.p, frags.baseq)
    got = A.assign_reads_haplotype(frags, cands, cfg, ct, False)
    want = OA.assign_reads_haplotype(f2, c2, cfg, False)
    assert got == want
    np.testing.assert_array_equal(frags.assignment, f2.assignment)
    np.testing.assert_array_equal(frags.haplotag, f2.haplotag)
    np.testing.assert_allclose(frags.assignment_score, f2.assignment_score,
                               rtol=1e-12, atol=1e-12)
    assert (frags.assignment != 0).sum() > 20


def test_assign_snp_matches_oracle(tmp_path, rng):
    cfg, cands, frags = _setup(tmp_path, rng)
    ct = make_cell_tables_np(frags.p, frags.baseq)
    A.assign_reads_haplotype(frags, cands, cfg, ct, False)
    c2, f2 = _clone(cands, frags)
    A.assign_snp_haplotype_genotype(frags, cands, cfg, ct, False)
    OA.assign_snp_haplotype_genotype(f2, c2, cfg, False)
    np.testing.assert_array_equal(cands.haplotype, c2.haplotype)
    np.testing.assert_array_equal(cands.genotype, c2.genotype)
    np.testing.assert_array_equal(cands.variant_type, c2.variant_type)
    np.testing.assert_array_equal(cands.non_selected, c2.non_selected)
    np.testing.assert_array_equal(cands.single, c2.single)
    np.testing.assert_allclose(cands.phase_score, c2.phase_score,
                               rtol=1e-12, atol=1e-12)
    assert (cands.phase_score > 0).sum() >= 5


def test_full_assignment_sequence_matches_oracle(tmp_path, rng):
    """The double assign pass sequence (thread.rs:168-172) end to end."""
    cfg, cands, frags = _setup(tmp_path, rng, n_het=9)
    c2, f2 = _clone(cands, frags)
    ct = make_cell_tables_np(frags.p, frags.baseq)
    for _ in range(2):
        A.assign_reads_haplotype(frags, cands, cfg, ct, False)
        A.assign_snp_haplotype_genotype(frags, cands, cfg, ct, False)
        OA.assign_reads_haplotype(f2, c2, cfg, False)
        OA.assign_snp_haplotype_genotype(f2, c2, cfg, False)
    np.testing.assert_array_equal(frags.assignment, f2.assignment)
    np.testing.assert_array_equal(cands.genotype, c2.genotype)
    np.testing.assert_allclose(cands.phase_score, c2.phase_score,
                               rtol=1e-12, atol=1e-12)


def _synth_large(rng, K=400, I=10000):
    """Synthetic [K,I] fragment/candidate state with ~30 cells per read."""
    from longcallr_tpu.ops.candidates import CandidateSet
    from longcallr_tpu.phasing.fragments import FragmentMatrix
    from longcallr_tpu.tiles.regions import Region

    p = np.zeros((K, I), dtype=np.int8)
    # contiguous spans: read k covers a window of candidates
    for k in range(K):
        lo = int(rng.integers(0, I - 40))
        w = int(rng.integers(10, 40))
        p[k, lo:lo + w] = rng.choice([-1, 1], size=w)
        p[k, lo:lo + w] *= (rng.random(w) > 0.05).astype(np.int8)
    baseq = np.where(p != 0, rng.integers(10, 31, size=(K, I)), 0).astype(np.uint8)
    frags = FragmentMatrix(
        region=Region(chr="chrX", start=1, end=I * 10),
        p=p, baseq=baseq, qnames=[f"q{k}" for k in range(K)],
        num_hete_links=(p != 0).sum(axis=1).astype(np.int32),
        for_phasing=np.ones(K, bool), downsampled=np.ones(K, bool),
        haplotag=rng.choice([-1, 0, 1], size=K).astype(np.int8),
        assignment=rng.integers(0, 3, size=K).astype(np.int8),
        assignment_score=np.zeros(K))
    n = I
    cands = CandidateSet(
        chrom="chrX", pos=np.arange(n, dtype=np.int64) * 10,
        ref_base=np.full(n, ord("A"), np.uint8),
        alleles=np.full((n, 2), ord("C"), np.uint8),
        allele_freqs=np.zeros((n, 2), np.float32),
        alt_frac=np.zeros((n, 2), np.float32),
        depth=np.full(n, 30, np.int32),
        variant_quality=np.full(n, 60.0),
        genotype_quality=np.full(n, 60.0),
        genotype_prob=np.zeros((n, 3)),
        variant_type=rng.choice([0, 1, 1, 1, 2], size=n).astype(np.int8),
        genotype=np.zeros(n, np.int8),
        haplotype=rng.choice([-1, 1], size=n).astype(np.int8),
        rna_editing=rng.random(n) < 0.02,
        cand_somatic=rng.random(n) < 0.02,
        dense=np.zeros(n, bool),
        hom_var=np.zeros(n, bool), het_var=np.ones(n, bool),
        for_phasing=rng.random(n) < 0.9,
        single=np.zeros(n, bool), non_selected=np.zeros(n, bool),
        somatic=np.zeros(n, bool), somatic_score=np.zeros(n),
        phase_score=np.zeros(n), phase_set=np.zeros(n, np.uint32))
    return frags, cands


def test_assignment_layer_scales_to_10k_candidates():
    """The per-SNP flag loop and the rescue loop must
    stay vectorised — 10k candidates in well under the interpreter-bound
    regime, outputs equal to the scalar oracle."""
    import time
    rng = np.random.default_rng(3)
    frags, cands = _synth_large(rng)
    cfg = preset("hifi-masseq")
    ct = make_cell_tables_np(frags.p, frags.baseq)
    A._t4(ct)  # prime the table cache outside the timed window
    c2 = copy.deepcopy(cands)
    f2 = copy.deepcopy(frags)

    t0 = time.monotonic()
    A.assign_snp_haplotype_genotype(frags, cands, cfg, ct, False)
    idx = np.nonzero(cands.rna_editing)[0]
    A._eval_rescue(frags, cands, cfg, ct, idx, 8.0, False,
                   np.random.default_rng(5), "edit")
    dt = time.monotonic() - t0
    assert dt < 1.0, f"assignment stages took {dt:.3f}s at I=10k"

    OA.assign_snp_haplotype_genotype(f2, c2, cfg, False)
    np.testing.assert_array_equal(cands.genotype[~cands.rna_editing & ~c2.rna_editing],
                                  c2.genotype[~cands.rna_editing & ~c2.rna_editing])
    np.testing.assert_array_equal(frags.haplotag[frags.assignment == 0],
                                  f2.haplotag[f2.assignment == 0])
