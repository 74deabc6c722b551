"""Matvec-form kernels vs the reference-form kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from longcallr_tpu.phasing import kernels as KK
from longcallr_tpu.phasing.kernels_fast import (fast_read_logliks,
                                                fast_snp_sums,
                                                make_fast_tables)


def _data(rng, K=60, I=24):
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(3, 31, size=(K, I)).astype(np.uint8)
    ct = KK.make_cell_tables(p, q)
    sigma = jnp.asarray(rng.choice([-1.0, 1.0], size=K))
    delta = jnp.asarray(rng.choice([-1.0, 1.0], size=I))
    eta = jnp.asarray(rng.choice([-1.0, 0.0, 0.0, 1.0], size=I))
    site = jnp.asarray(rng.random(I) < 0.9)
    rbase = jnp.asarray(rng.random(K) < 0.95)
    return ct, sigma, delta, eta, site, rbase


def test_fast_read_logliks(rng):
    ct, sigma, delta, eta, site, rbase = _data(rng)
    rm = rbase & (sigma != 0)
    ft = make_fast_tables(ct, rm, site)
    lp_f, lm_f, nc_f = fast_read_logliks(ft, delta, eta)
    lp, lm, nc = KK.read_logliks(ct, delta, eta, site[None, :])
    np.testing.assert_allclose(np.asarray(lp_f), np.asarray(lp), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(lm_f), np.asarray(lm), rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(nc_f), np.asarray(nc))


def test_fast_snp_sums(rng):
    ct, sigma, delta, eta, site, rbase = _data(rng)
    rm = rbase & (sigma != 0)
    ft = make_fast_tables(ct, rm, site)
    got = fast_snp_sums(ft, sigma, delta)
    want = KK.snp_sums(ct, sigma, delta, rm, site)
    for g, w, name in zip(got, want,
                          ["s_match", "s_flip", "s_refe", "s_alte", "cov"]):
        if name == "cov":
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-12, atol=1e-12, err_msg=name)


def test_fast_cross_optimize_equivalent(rng, monkeypatch):
    """A full ascent with the f64 matvec kernels lands on the same q-values
    within tolerance (states may differ only on exact fp ties). The f32-split
    mode has its own equivalence test; pin this one to the f64 fast path so
    it holds under any LONGCALLR_* environment."""
    from longcallr_tpu.phasing import optimize as opt
    from longcallr_tpu.phasing.optimize import (PhaseState,
                                                _cross_optimize_fast_loop,
                                                _cross_optimize_loop)
    monkeypatch.setattr(opt, "USE_F32_KERNELS", False)
    ct, sigma, delta, eta, site, rbase = _data(rng, K=80, I=20)
    st0 = PhaseState(jnp.where(rbase, sigma, 0.0), delta, eta)
    cons = jnp.zeros(delta.shape[0], bool)
    st_a, prob_a = _cross_optimize_loop(ct, st0, rbase, site, cons, False, False)
    st_b, prob_b = _cross_optimize_fast_loop(ct, st0, rbase, site, cons, False, False)
    np.testing.assert_allclose(float(prob_a), float(prob_b), rtol=1e-9)
    agree = (np.asarray(st_a.sigma) == np.asarray(st_b.sigma)).mean()
    assert agree > 0.97, agree


@pytest.mark.parametrize("placement", [
    "cpu", pytest.param("gpu", marks=pytest.mark.gpu)])
def test_f32_split_matvecs_accurate(rng, placement, request):
    """hi/lo split matvecs vs the f64 matvec: representation is f64-exact to
    ~2^-48, so the only error is chunked-f32 accumulation (~1e-5 here). On
    a GPU this holds only because every contraction states HIGHEST (TF32
    would miss the bound by orders of magnitude)."""
    dev = (request.getfixturevalue("gpu_device") if placement == "gpu"
           else jax.devices("cpu")[0])
    with jax.default_device(dev):
        _split_matvecs_accurate(rng)


def _split_matvecs_accurate(rng):
    from longcallr_tpu.phasing.kernels_fast import (_matvec_cols,
                                                    _matvec_rows,
                                                    make_fast_tables32,
                                                    split_f32)
    ct, sigma, delta, eta, site, rbase = _data(rng, K=600, I=96)
    rm = rbase & (sigma != 0)
    ft = make_fast_tables(ct, rm, site)
    hi, lo = split_f32(ft.dp)
    # split is an exact two-term decomposition at f64 precision
    np.testing.assert_allclose(
        np.asarray(hi, np.float64) + np.asarray(lo, np.float64),
        np.asarray(ft.dp), rtol=0, atol=3e-13)
    u = jnp.where(eta == 0, delta, 0.0)
    want_r = np.asarray(ft.dp @ u)
    got_r = np.asarray(_matvec_rows(jnp.stack([hi, lo]), u))
    np.testing.assert_allclose(got_r, want_r, atol=2e-4)
    s = jnp.where(rm, sigma, 0.0)
    want_c = np.asarray(ft.dp.T @ s)
    got_c = np.asarray(_matvec_cols(jnp.stack([hi, lo]), s))
    np.testing.assert_allclose(got_c, want_c, atol=2e-4)
    ft32 = make_fast_tables32(ct, rm, site)
    np.testing.assert_array_equal(np.asarray(ft32.row_b),
                                  np.asarray(ft.row_b))


def test_f32_mode_cross_optimize_equivalent(rng, monkeypatch):
    """Decision stability: the f32-split ascent reaches a state of the same
    quality as the f64 ascent (objectives match to ~1e-6 relative; individual
    near-tie flips allowed)."""
    from longcallr_tpu.phasing import optimize as opt
    ct, sigma, delta, eta, site, rbase = _data(rng, K=512, I=32)
    st0 = opt.PhaseState(jnp.where(rbase, sigma, 0.0), delta, eta)
    cons = jnp.zeros(delta.shape[0], bool)
    st_a, prob_a = opt._cross_optimize_fast_loop(
        ct, st0, rbase, site, cons, False, False)
    monkeypatch.setattr(opt, "USE_F32_KERNELS", True)
    st_b, prob_b = opt._cross_optimize_fast_loop(
        ct, st0, rbase, site, cons, False, False)
    np.testing.assert_allclose(float(prob_a), float(prob_b), rtol=1e-6)
    agree = (np.asarray(st_a.sigma) == np.asarray(st_b.sigma)).mean()
    assert agree > 0.95, agree
    agree_d = (np.asarray(st_a.delta) == np.asarray(st_b.delta)).mean()
    assert agree_d > 0.9, agree_d


def test_f32_mode_phase_region_truth(tmp_path, rng, monkeypatch, request):
    """End-to-end under LONGCALLR_F32_KERNELS: simulated truth recovered."""
    from longcallr_tpu.config import preset
    from longcallr_tpu.io.bam import BamFile
    from longcallr_tpu.ops.candidates import select_candidates
    from longcallr_tpu.phasing import optimize as opt
    from longcallr_tpu.phasing.fragments import get_fragments
    from longcallr_tpu.tiles.pileup import build_pileup
    from longcallr_tpu.tiles.regions import Region
    from simulate import make_reference, plant_snps, simulate_bam

    import jax
    monkeypatch.setattr(opt, "USE_FAST_KERNELS", True)
    monkeypatch.setattr(opt, "USE_F32_KERNELS", True)
    # mode flags are baked into traces at trace time: drop any executables
    # compiled for these shapes under other modes, and drop ours afterwards
    jax.clear_caches()
    request.addfinalizer(jax.clear_caches)
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=18, n_hom=0, min_gap=8000 // 19)
    path = str(tmp_path / "f32.bam")
    simulate_bam(path, rng, ref, truth, n_reads=80, read_len=4000,
                 err_rate=0.01)
    bam = BamFile(path)
    region = Region(chr="chrS", start=1, end=len(ref) + 1)
    pl = build_pileup(bam, region, ref, cfg)
    cands = select_candidates(pl, cfg)
    frags = get_fragments(bam, region, cands, cfg)
    st = opt.phase_region(frags, cands, cfg, seed=1)
    sig = np.sign(np.asarray(st.sigma))
    hap_true = np.array([truth.hap_of_read[qn] for qn in frags.qnames])
    act = sig != 0
    same = (sig[act] == np.where(hap_true[act] == 1, 1, -1)).mean()
    assert same > 0.9 or same < 0.1, same


def _mk_region(tmp_path, rng, n_het=14):
    from longcallr_tpu.config import preset
    from longcallr_tpu.io.bam import BamFile
    from longcallr_tpu.ops.candidates import select_candidates
    from longcallr_tpu.phasing.fragments import get_fragments
    from longcallr_tpu.tiles.pileup import build_pileup
    from longcallr_tpu.tiles.regions import Region
    from simulate import make_reference, plant_snps, simulate_bam

    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=n_het, n_hom=0, min_gap=8500 // (n_het + 1))
    path = str(tmp_path / "f32net.bam")
    simulate_bam(path, rng, ref, truth, n_reads=60, read_len=4000,
                 err_rate=0.01)
    bam = BamFile(path)
    region = Region(chr="chrS", start=1, end=len(ref) + 1)
    pl = build_pileup(bam, region, ref, cfg)
    cands = select_candidates(pl, cfg)
    frags = get_fragments(bam, region, cands, cfg)
    return cfg, cands, frags


def test_f64_margin_nonnegative_at_f64_fixed_point(tmp_path, rng):
    """The decision-gap statistic is well-formed at a converged f64 state:
    nonnegative and finite. (It is NOT asserted to exceed the safety bound:
    a read with weak evidence — e.g. covering one ambiguous site — can have
    a genuinely tiny |q − q_flip| gap even on clean data; the net firing on
    such a region just costs one cheap f64 rerun.)"""
    from longcallr_tpu.phasing import optimize as opt
    from longcallr_tpu.phasing.kernels import make_cell_tables_np, CellTables
    from longcallr_tpu.phasing.optimize import (PhaseState, f64_decision_margin,
                                                phase_region)

    cfg, cands, frags = _mk_region(tmp_path, rng)
    assert cands.n > cfg.max_enum_snps, "need the iterative path"
    st = phase_region(frags, cands, cfg, seed=3)
    K0, I0 = frags.p.shape
    ct = CellTables(*(jnp.asarray(np.asarray(a))
                      for a in make_cell_tables_np(frags.p, frags.baseq)))
    margin = float(f64_decision_margin(
        ct, PhaseState(jnp.asarray(np.asarray(st.sigma)),
                       jnp.asarray(np.asarray(st.delta)),
                       jnp.asarray(np.asarray(st.eta))),
        jnp.asarray(frags.for_phasing), jnp.asarray(cands.for_phasing)))
    assert np.isfinite(margin) and margin >= 0.0, margin


def test_f32_safety_net_recomputes_near_ties(tmp_path, rng, monkeypatch):
    """With f32 mode faked on (as on an accelerator placement) and the margin
    bound raised above every real margin, the net must recompute in f64 and
    land on the pure-f64 result — for the per-region AND batched drivers."""
    from longcallr_tpu.phasing import batch_driver as BD
    from longcallr_tpu.phasing import optimize as opt
    from longcallr_tpu.phasing.batch_driver import phase_regions_batched
    from longcallr_tpu.phasing.optimize import phase_region

    cfg, cands, frags = _mk_region(tmp_path, rng)
    assert cands.n > cfg.max_enum_snps

    want = phase_region(frags, cands, cfg, seed=3)  # pure f64 (CPU auto)

    def fake_f32():
        # the split on every placement except an explicit CPU
        # default-device context (the net's rerun placement)
        dev = jax.config.jax_default_device
        return not (dev is not None and dev.platform == "cpu")

    jax.clear_caches()  # drop f64-traced programs for these shapes
    monkeypatch.setattr(opt, "_f32_mode", fake_f32)
    try:
        monkeypatch.setattr(opt, "F32_SAFETY_TOL", np.inf)  # always trigger
        got = phase_region(frags, cands, cfg, seed=3)
        np.testing.assert_array_equal(np.asarray(got.sigma),
                                      np.asarray(want.sigma))
        np.testing.assert_array_equal(np.asarray(got.delta),
                                      np.asarray(want.delta))
        np.testing.assert_array_equal(np.asarray(got.eta),
                                      np.asarray(want.eta))
        got_b = phase_regions_batched(
            [(frags, cands, 3, False), (frags, cands, 3, False)], cfg)
        for stb in got_b:
            np.testing.assert_array_equal(np.asarray(stb.sigma),
                                          np.asarray(want.sigma))
            np.testing.assert_array_equal(np.asarray(stb.delta),
                                          np.asarray(want.delta))
    finally:
        jax.clear_caches()  # drop the f32-traced programs again


def test_f32_safety_net_enum_path(tmp_path, rng, monkeypatch):
    """Round-2 advisor: the ENUMERATION path (≤ max_enum_snps candidates)
    also re-checks in f64 under f32 mode — winning-config margins AND the
    strictly-below config gap — and recomputes on the host when triggered,
    in both the per-region and the batched-bucket drivers."""
    from longcallr_tpu.phasing import optimize as opt
    from longcallr_tpu.phasing.batch_driver import phase_regions_batched
    from longcallr_tpu.phasing.optimize import phase_region

    cfg, cands, frags = _mk_region(tmp_path, rng, n_het=4)
    assert 0 < cands.n <= cfg.max_enum_snps, "need the enumeration path"

    want = phase_region(frags, cands, cfg, seed=3)  # pure f64 (CPU auto)

    def fake_f32():
        dev = jax.config.jax_default_device
        return not (dev is not None and dev.platform == "cpu")

    jax.clear_caches()
    monkeypatch.setattr(opt, "_f32_mode", fake_f32)
    try:
        monkeypatch.setattr(opt, "F32_SAFETY_TOL", np.inf)  # always trigger
        got = phase_region(frags, cands, cfg, seed=3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # batched enum bucket (two same-shape regions share the bucket)
        got_b = phase_regions_batched(
            [(frags, cands, 3, False), (frags, cands, 3, False)], cfg)
        for stb in got_b:
            for a, b in zip(stb, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    finally:
        jax.clear_caches()


def test_expand_cells_bit_equals_host_tables(rng):
    """On-device table expansion (kernels.expand_cells — the compact
    2-byte/cell transfer form) must be bit-identical to host
    make_cell_tables_np: same gather from the same f64 log10 tables."""
    import jax
    from longcallr_tpu.phasing.kernels import (CompactCells, expand_cells,
                                               make_cell_tables_np)

    p = rng.choice([-1, 0, 1], size=(64, 48), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(0, 31, size=(64, 48)).astype(np.uint8)
    host = make_cell_tables_np(p, q)
    dev = jax.jit(expand_cells)(CompactCells(jnp.asarray(p), jnp.asarray(q)))
    np.testing.assert_array_equal(np.asarray(dev.p), np.asarray(host.p))
    np.testing.assert_array_equal(np.asarray(dev.lerr), np.asarray(host.lerr))
    np.testing.assert_array_equal(np.asarray(dev.l1m), np.asarray(host.l1m))
    np.testing.assert_array_equal(np.asarray(dev.exists), np.asarray(host.exists))


def test_fast_margin_matches_reference_margin(rng):
    """f64_decision_margin_fast (matvec-form, compact input) equals the
    reference-form f64_decision_margin to ~1e-12 — the safety-net trigger
    semantics are preserved."""
    from longcallr_tpu.phasing.kernels import CompactCells, make_cell_tables
    from longcallr_tpu.phasing.optimize import (PhaseState,
                                                f64_decision_margin,
                                                f64_decision_margin_fast)

    K, I = 48, 24
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(10, 31, size=(K, I)).astype(np.uint8)
    sigma = jnp.asarray(rng.choice([-1.0, 1.0], K))
    delta = jnp.asarray(rng.choice([-1.0, 1.0], I))
    eta = jnp.asarray(rng.choice([-1.0, 0.0, 1.0], I))
    rb = jnp.asarray(rng.random(K) < 0.9)
    sm = jnp.asarray(rng.random(I) < 0.9)
    st = PhaseState(sigma, delta, eta)
    ref = float(f64_decision_margin(make_cell_tables(p, q), st, rb, sm))
    fast = float(f64_decision_margin_fast(jnp.asarray(p), jnp.asarray(q),
                                          sigma, delta, eta, rb, sm))
    assert abs(ref - fast) <= 1e-9 * max(1.0, abs(ref))


def test_prebuilt_fast_tables_bit_identical(rng):
    """The schedule-level fast-table hoist (optimize._fast_tables_for +
    ft= argument) must be bit-identical to per-call builds: same inputs,
    same gather — only the redundant rebuilds are elided."""
    from longcallr_tpu.phasing.kernels import make_cell_tables
    from longcallr_tpu.phasing.optimize import (PhaseState,
                                                _cross_optimize_fast_loop_it,
                                                _fast_tables_for)

    K, I = 64, 32
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(10, 31, size=(K, I)).astype(np.uint8)
    ct = make_cell_tables(p, q)
    rb = jnp.asarray(rng.random(K) < 0.9)
    sigma0 = jnp.asarray(np.where(np.asarray(rb), rng.choice([-1.0, 1.0], K), 0.0))
    st = PhaseState(sigma0, jnp.asarray(rng.choice([-1.0, 1.0], I)),
                    jnp.zeros(I))
    sm = jnp.ones(I, bool)
    cons = jnp.zeros(I, bool)
    a_st, a_p, a_it = _cross_optimize_fast_loop_it(ct, st, rb, sm, cons,
                                                   False, False)
    ft = _fast_tables_for(ct, rb, st.sigma, sm)
    b_st, b_p, b_it = _cross_optimize_fast_loop_it(ct, st, rb, sm, cons,
                                                   False, False, ft=ft)
    assert float(a_p) == float(b_p) and int(a_it) == int(b_it)
    for x, y in zip(a_st, b_st):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_perturbation_stats_matches_schedule(rng):
    """perturbation_phase_stats (the bench's instrumented variant) must be
    bit-identical to perturbation_phase — it only adds iteration counting."""
    from longcallr_tpu.phasing.kernels import make_cell_tables
    from longcallr_tpu.phasing.optimize import (PhaseState,
                                                perturbation_phase,
                                                perturbation_phase_stats,
                                                selected_loop)
    import jax

    K, I = 96, 24
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(10, 31, size=(K, I)).astype(np.uint8)
    ct = make_cell_tables(p, q)
    rb = jnp.asarray(rng.random(K) < 0.9)
    st0 = PhaseState(
        jnp.asarray(np.where(np.asarray(rb), rng.choice([-1.0, 1.0], K), 0.0)),
        jnp.asarray(rng.choice([-1.0, 1.0], I)), jnp.zeros(I))
    sm = jnp.ones(I, bool)
    cons = jnp.zeros(I, bool)
    st1, prob = selected_loop()(ct, st0, rb, sm, cons, False, False)
    key = jax.random.PRNGKey(5)
    n_rounds = jnp.int32(I // 4 + 1)
    a_st, a_p = perturbation_phase(ct, st1, st1, prob, rb, sm, cons,
                                   n_rounds, key)
    b_st, b_p, iters = perturbation_phase_stats(ct, st1, st1, prob, rb, sm,
                                                cons, n_rounds, key)
    assert float(a_p) == float(b_p)
    assert int(iters) > 0
    for x, y in zip(a_st, b_st):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_phase_work_routing(monkeypatch):
    """Work-based phase routing: below LONGCALLR_MIN_ACCEL_PHASE_WORK the
    phase runs on the host backend; above it on the default device. On the
    CPU-only test backend both resolve to None (default device) — the
    threshold logic is tested against a fake accelerator default."""
    from longcallr_tpu.utils import device as D

    # CPU default → always None (no cross-device hop)
    assert D.phase_problem_device(1) is None
    assert D.phase_problem_device(1 << 40) is None

    class _Fake:
        platform = "gpu"

    cpu = jax.devices("cpu")[0]
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [cpu] if a == ("cpu",) else [_Fake()])
    assert D.phase_problem_device(D.MIN_ACCEL_PHASE_WORK - 1) is cpu
    assert D.phase_problem_device(D.MIN_ACCEL_PHASE_WORK) is None


def test_degraded_placement_surfaced(caplog):
    """Round-2 review: when work-based routing wants the accelerator but the
    default backend is CPU (wedge/fallback), a warning fires and the landing
    is counted — a silent ~100x phase regression must be visible."""
    import logging

    from longcallr_tpu.utils import device as D

    before = D.DEGRADED_PLACEMENTS
    D._warned_degraded = False
    with caplog.at_level(logging.WARNING, logger="longcallr_tpu"):
        # the test backend is CPU-only: an accelerator-scale problem lands
        # on the host → degraded
        assert D.phase_problem_device(D.MIN_ACCEL_PHASE_WORK) is None
        assert D.phase_problem_device(D.MIN_ACCEL_PHASE_WORK * 2) is None
    assert D.DEGRADED_PLACEMENTS == before + 2
    assert sum("expect ~100x slower deep phasing" in r.getMessage()
               for r in caplog.records) == 1   # warned once per process
    # sub-threshold problems are CPU-by-design, never counted
    mid = D.DEGRADED_PLACEMENTS
    assert D.phase_problem_device(1) is None
    assert D.DEGRADED_PLACEMENTS == mid


def test_batched_perturbation_stats_matches_schedule(rng):
    """batched_perturbation_phase_stats (the bench MFU probe's production
    kernel) must be bit-identical to batched_perturbation_phase — it only
    adds the batch-ascent-iteration counter."""
    import jax
    from longcallr_tpu.parallel.mesh import (
        BatchedRegions, batched_cross_optimize, batched_perturbation_phase,
        batched_perturbation_phase_stats)

    B, K, I = 3, 96, 24
    p = rng.choice([-1, 0, 1], size=(B, K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(10, 31, size=(B, K, I)).astype(np.uint8)
    rb = rng.random((B, K)) < 0.9
    batch = BatchedRegions(p=jnp.asarray(p), q=jnp.asarray(q),
                           read_base=jnp.asarray(rb),
                           site_mask=jnp.ones((B, I), bool),
                           conserved=jnp.zeros((B, I), bool))
    sigma0 = jnp.asarray(np.where(rb, rng.choice([-1.0, 1.0], (B, K)), 0.0))
    delta0 = jnp.asarray(rng.choice([-1.0, 1.0], (B, I)))
    sg1, dl1, et1, pr1 = batched_cross_optimize(
        batch, sigma0, delta0, jnp.zeros((B, I)),
        keep_conserved=False, with_genotype=False)
    n_rounds = jnp.asarray(np.array([I // 4 + 1, 3, 5], np.int32))
    keys = jnp.stack([jax.random.PRNGKey(5 + b) for b in range(B)])
    a = batched_perturbation_phase(batch, sg1, dl1, et1, pr1, n_rounds, keys)
    b = batched_perturbation_phase_stats(batch, sg1, dl1, et1, pr1, n_rounds,
                                         keys)
    assert int(b[4]) > 0
    for x, y in zip(a, b[:4]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_fused_compact_tables_match_split_build(rng):
    """fast_tables32_from_compact vs expand-then-split (make_fast_tables32):
    dp2 bit-identical; row_b/col_b within an ulp (one final rounding of the
    exact integer-q sum); diff sums within the mode's f32-chunk bound;
    counts exact."""
    from longcallr_tpu.phasing.kernels import CompactCells, make_cell_tables
    from longcallr_tpu.phasing.kernels_fast import (
        fast_tables32_from_compact, make_fast_tables32)

    K, I = 600, 96
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(5, 31, size=(K, I)).astype(np.uint8)
    rm = jnp.asarray(rng.random(K) < 0.9)
    sm = jnp.asarray(rng.random(I) < 0.95)
    ct = make_cell_tables(p, q)
    ref = make_fast_tables32(ct, rm, sm)
    got = fast_tables32_from_compact(
        CompactCells(jnp.asarray(p), jnp.asarray(q)), rm, sm)
    np.testing.assert_array_equal(np.asarray(got.dp2), np.asarray(ref.dp2))
    np.testing.assert_allclose(np.asarray(got.row_b), np.asarray(ref.row_b),
                               rtol=1e-14, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.col_b), np.asarray(ref.col_b),
                               rtol=1e-14, atol=1e-12)
    for name in ("row_dif", "col_dif", "col_dp"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)), atol=2e-4)
    np.testing.assert_array_equal(np.asarray(got.row_cells),
                                  np.asarray(ref.row_cells))
    np.testing.assert_array_equal(np.asarray(got.cov), np.asarray(ref.cov))


# ---------------------------------------------------------------------------
# Device block-flip pass (kernels_fast.fast_block_flip32)
# ---------------------------------------------------------------------------

def _synth_blocks(rng, I, n_blocks=5, max_size=4):
    """Random disjoint column blocks → (LDInfo-compatible blocks, block_id)."""
    from longcallr_tpu.phasing.optimize import LDInfo
    cols = rng.permutation(I)
    blocks, block_id = [], np.full(I, -1, np.int32)
    pos = 0
    for bid in range(n_blocks):
        size = int(rng.integers(2, max_size + 1))
        if pos + size > I:
            break
        comp = np.sort(cols[pos:pos + size]).astype(np.int64)
        blocks.append(comp)
        block_id[comp] = bid
        pos += size
    return LDInfo(pair_ld=None, blocks=blocks, block_id=block_id, adj=None), \
        block_id


def test_device_block_flip_matches_host(rng):
    """fast_block_flip32 reproduces block_flip_pass's per-block decisions
    (and therefore the flipped states exactly — the apply is sign flips of
    identical inputs) whenever the normalised margin clears the envelope;
    fuzzed over seeds and shapes."""
    from longcallr_tpu.phasing.kernels import make_cell_tables_np
    from longcallr_tpu.phasing.kernels_fast import (F32_BF_TOL,
                                                    fast_block_flip32,
                                                    make_fast_tables32)
    from longcallr_tpu.phasing.optimize import PhaseState, block_flip_pass

    checked = 0
    for seed in range(6):
        r = np.random.default_rng(seed)
        K, I = int(r.integers(40, 90)), int(r.integers(16, 40))
        # planted diploid structure so block decisions have real margins:
        # p = h_k · δ*_i with sequencing errors; the current state carries
        # whole-block δ errors that the flip pass should correct
        hap = r.choice([-1, 1], size=K)
        true_delta = r.choice([-1.0, 1.0], size=I)
        exists = r.random((K, I)) < 0.6
        p = (hap[:, None] * true_delta[None, :]).astype(np.int8)
        flips = r.random((K, I)) < 0.05
        p = np.where(flips, -p, p)
        p = np.where(exists, p, 0).astype(np.int8)
        q = r.integers(3, 31, size=(K, I)).astype(np.uint8)
        rbase = r.random(K) < 0.95
        sigma = np.where(rbase, hap.astype(np.float64), 0.0)
        ld, block_id = _synth_blocks(r, I)
        # flip some whole blocks' delta so the pass has work to do
        delta = true_delta.copy()
        for comp in ld.blocks[::2]:
            delta[comp] = -delta[comp]
        eta = np.zeros(I)
        site = r.random(I) < 0.9

        ct_np = make_cell_tables_np(p, q)
        st2 = block_flip_pass(ct_np, PhaseState(sigma, delta, eta), rbase,
                              site, np.asarray(ct_np.exists), ld)

        rm = jnp.asarray(rbase & (sigma != 0))
        ft = make_fast_tables32(KK.make_cell_tables(p, q), rm,
                                jnp.asarray(site))
        sg_d, dl_d, margin = fast_block_flip32(
            ft, jnp.asarray(p), jnp.asarray(sigma), jnp.asarray(delta),
            jnp.asarray(eta), jnp.asarray(site), jnp.asarray(block_id))
        if float(margin) < F32_BF_TOL:
            continue  # near-tie data: the driver recomputes on the host
        np.testing.assert_array_equal(np.asarray(dl_d), np.asarray(st2.delta))
        np.testing.assert_array_equal(np.asarray(sg_d), np.asarray(st2.sigma))
        checked += 1
    assert checked >= 4, f"only {checked} seeds had clear margins"


def test_device_block_flip_no_blocks_identity(rng):
    """With no LD blocks the pass is the identity (host returns the state
    unchanged; the device kernel must too, with an infinite margin)."""
    from longcallr_tpu.phasing.kernels_fast import (fast_block_flip32,
                                                    make_fast_tables32)

    K, I = 32, 16
    r = np.random.default_rng(7)
    p = r.choice([-1, 0, 1], size=(K, I)).astype(np.int8)
    q = r.integers(3, 31, size=(K, I)).astype(np.uint8)
    sigma = r.choice([-1.0, 1.0], size=K)
    delta = r.choice([-1.0, 1.0], size=I)
    eta = np.zeros(I)
    site = np.ones(I, bool)
    rm = jnp.asarray(sigma != 0)
    ft = make_fast_tables32(KK.make_cell_tables(p, q), rm, jnp.asarray(site))
    sg_d, dl_d, margin = fast_block_flip32(
        ft, jnp.asarray(p), jnp.asarray(sigma), jnp.asarray(delta),
        jnp.asarray(eta), jnp.asarray(site),
        jnp.asarray(np.full(I, -1, np.int32)))
    assert np.isinf(float(margin))
    np.testing.assert_array_equal(np.asarray(sg_d), sigma)
    np.testing.assert_array_equal(np.asarray(dl_d), delta)


def test_batched_driver_device_flip_matches_host_flip(tmp_path, rng, monkeypatch):
    """In-situ gate: the batched driver under f32 mode produces byte-identical
    states whether the block-flip pass runs as the device kernel (default)
    or is forced entirely onto the exact host path (F32_BF_TOL = inf ⇒
    every region's margin 'fails' and _flip_one recomputes) — i.e. the
    device decisions match the host decisions on real pipeline data."""
    from longcallr_tpu.phasing import kernels_fast as KF
    from longcallr_tpu.phasing import optimize as opt
    from longcallr_tpu.phasing.batch_driver import phase_regions_batched

    cfg, cands, frags = _mk_region(tmp_path, rng)
    assert cands.n > cfg.max_enum_snps, "need the iterative path"
    rng2 = np.random.default_rng(991)
    cfg2, cands2, frags2 = _mk_region(tmp_path, rng2, n_het=12)

    def fake_f32():
        dev = jax.config.jax_default_device
        return not (dev is not None and dev.platform == "cpu")

    jax.clear_caches()
    monkeypatch.setattr(opt, "USE_F32_KERNELS", True)
    monkeypatch.setattr(opt, "_f32_mode", fake_f32)
    items = [(frags, cands, 3, False), (frags2, cands2, 5, False)]
    try:
        got_dev = phase_regions_batched(items, cfg)
        monkeypatch.setattr(KF, "F32_BF_TOL", np.inf)
        got_host = phase_regions_batched(items, cfg)
    finally:
        jax.clear_caches()
    for a, b in zip(got_dev, got_host):
        np.testing.assert_array_equal(np.asarray(a.sigma), np.asarray(b.sigma))
        np.testing.assert_array_equal(np.asarray(a.delta), np.asarray(b.delta))
        np.testing.assert_array_equal(np.asarray(a.eta), np.asarray(b.eta))


def test_device_block_flip_symmetric_block_exact(rng):
    """A block that fully contains every active read is the global-flip
    symmetry: the host's per-block Δ is EXACTLY 0.0 (bit-identical sums, no
    flip under strict <). The device kernel must detect this case with
    integer logic — no flip, margin +inf (no host fallback) — instead of
    reporting pure f32 noise."""
    from longcallr_tpu.phasing.kernels import make_cell_tables_np
    from longcallr_tpu.phasing.kernels_fast import (fast_block_flip32,
                                                    make_fast_tables32)
    from longcallr_tpu.phasing.optimize import (LDInfo, PhaseState,
                                                block_flip_pass)

    K, I = 48, 20
    r = np.random.default_rng(5)
    hap = r.choice([-1, 1], size=K)
    true_delta = r.choice([-1.0, 1.0], size=I)
    exists = r.random((K, I)) < 0.7
    p = (hap[:, None] * true_delta[None, :]).astype(np.int8)
    p = np.where(r.random((K, I)) < 0.05, -p, p)
    p = np.where(exists, p, 0).astype(np.int8)
    q = r.integers(3, 31, size=(K, I)).astype(np.uint8)
    sigma = hap.astype(np.float64)
    delta = true_delta.copy()
    eta = np.zeros(I)
    site = np.ones(I, bool)
    # ONE block over all columns → every read fully contained
    block_id = np.zeros(I, np.int32)
    ld = LDInfo(pair_ld=None, blocks=[np.arange(I)], block_id=block_id,
                adj=None)

    ct_np = make_cell_tables_np(p, q)
    st2 = block_flip_pass(ct_np, PhaseState(sigma, delta, eta),
                          np.ones(K, bool), site, np.asarray(ct_np.exists),
                          ld)
    np.testing.assert_array_equal(st2.delta, delta)   # symmetric: no flip

    rm = jnp.asarray(sigma != 0)
    ft = make_fast_tables32(KK.make_cell_tables(p, q), rm, jnp.asarray(site))
    sg_d, dl_d, margin = fast_block_flip32(
        ft, jnp.asarray(p), jnp.asarray(sigma), jnp.asarray(delta),
        jnp.asarray(eta), jnp.asarray(site), jnp.asarray(block_id))
    assert np.isinf(float(margin)), float(margin)
    np.testing.assert_array_equal(np.asarray(dl_d), delta)
    np.testing.assert_array_equal(np.asarray(sg_d), sigma)


def test_per_region_device_flip_matches_host_flip(tmp_path, rng, monkeypatch):
    """The per-region iterative path under f32 mode is byte-identical
    whether its block-flip pass runs as the device kernel (default) or is
    forced onto the exact host pass (huge F32_BF_TOL ⇒ every finite margin
    'fails') — i.e. the device decisions match the host decisions inside
    the otherwise-identical pipeline."""
    from longcallr_tpu.phasing import kernels_fast as KF
    from longcallr_tpu.phasing import optimize as opt
    from longcallr_tpu.phasing.optimize import phase_region

    cfg, cands, frags = _mk_region(tmp_path, rng)
    assert cands.n > cfg.max_enum_snps, "need the iterative path"

    def fake_f32():
        dev = jax.config.jax_default_device
        return not (dev is not None and dev.platform == "cpu")

    jax.clear_caches()
    monkeypatch.setattr(opt, "_f32_mode", fake_f32)
    try:
        got_dev = phase_region(frags, cands, cfg, seed=3)
        monkeypatch.setattr(KF, "F32_BF_TOL", 1e30)
        got_host = phase_region(frags, cands, cfg, seed=3)
    finally:
        jax.clear_caches()
    for a, b in zip(got_dev, got_host):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pack_cells_roundtrip_exact(rng):
    """pack_cells_np → unpack_cells is bit-exact: p everywhere, q wherever a
    cell exists (q at p==0 cells is never consumed — every table masks by
    exists)."""
    from longcallr_tpu.phasing.kernels import pack_cells_np, unpack_cells
    for seed in range(3):
        r = np.random.default_rng(seed)
        p = r.choice([-1, 0, 1], size=(37, 19)).astype(np.int8)
        q = r.integers(0, 94, size=(37, 19)).astype(np.uint8)
        c = pack_cells_np(p, q)
        assert c.dtype == np.uint8
        p2, q2 = unpack_cells(jnp.asarray(c))
        np.testing.assert_array_equal(np.asarray(p2), p)
        np.testing.assert_array_equal(np.asarray(q2)[p != 0], q[p != 0])


def test_packed_transfer_driver_identity(tmp_path, rng, monkeypatch):
    """Forcing the accelerator-placement gate on (packed 1-byte transfer +
    device unpack) leaves the batched driver's outputs byte-identical to
    the direct 2-byte path."""
    from longcallr_tpu.phasing.batch_driver import phase_regions_batched
    from longcallr_tpu.utils import device as UD

    cfg, cands, frags = _mk_region(tmp_path, rng)
    items = [(frags, cands, 3, False), (frags, cands, 7, False)]
    want = phase_regions_batched(items, cfg)
    monkeypatch.setattr(UD, "accel_placement", lambda: True)
    got = phase_regions_batched(items, cfg)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _f32_contraction_cases():
    """(name, fn, args) for every f32 contraction in kernels_fast."""
    from longcallr_tpu.phasing import kernels_fast as KF

    K, I = 64, 32
    dp2 = jnp.zeros((2, K, I), jnp.float32)
    a32 = jnp.zeros((K, I), jnp.float32)
    ft = KF.FastTables32(dp2, *(jnp.zeros(K),) * 2, *(jnp.zeros(I),) * 3,
                         jnp.zeros(K, jnp.int32), jnp.zeros(I, jnp.int32),
                         jnp.ones(K, bool))
    p8 = jnp.ones((K, I), jnp.int8)
    zk, zi = jnp.ones(K), jnp.ones(I)
    return {
        "matvec_rows": (KF._matvec_rows, (dp2, jnp.zeros((I, 2)))),
        "matvec_cols": (KF._matvec_cols, (dp2, zk)),
        "ones_sum_rows": (KF._ones_sum_rows, (a32,)),
        "ones_sum_cols": (KF._ones_sum_cols, (a32,)),
        "block_flip": (KF.fast_block_flip32,
                       (ft, p8, zk, zi, jnp.zeros(I), jnp.ones(I, bool),
                        jnp.zeros(I, jnp.int32))),
    }


def _dot_generals(jaxpr):
    """Every dot_general of a jaxpr, nested sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    yield from _dot_generals(sub)


@pytest.mark.parametrize("name", ["matvec_rows", "matvec_cols",
                                  "ones_sum_rows", "ones_sum_cols",
                                  "block_flip"])
def test_f32_contractions_state_highest_precision(name):
    """Every f32 dot_general of the split mode carries precision HIGHEST:
    the split is f64-exact only if each f32 product is exact, and a GPU
    may run default-precision f32 matmuls in TF32."""
    fn, args = _f32_contraction_cases()[name]
    dots = [e for e in _dot_generals(jax.make_jaxpr(fn)(*args).jaxpr)
            if e.invars[0].aval.dtype == jnp.float32]
    assert dots, f"{name}: no f32 contraction traced"
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), (name, prec)


@pytest.mark.parametrize("platform,auto", [("cpu", False), ("gpu", True)])
def test_f32_mode_auto_rule(platform, auto, monkeypatch):
    """Auto mode keys on the placement's platform: native f64 on the CPU,
    the hi/lo split at HIGHEST on the GPU (measured on the H100, PERF.md);
    the env override wins on every platform."""
    from longcallr_tpu.phasing import optimize as opt

    monkeypatch.setattr(opt, "USE_F32_KERNELS", None)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert opt._f32_mode() is auto
    # an explicit default-device context (the host-routed placement) wins
    with jax.default_device(jax.devices("cpu")[0]):
        assert opt._f32_mode() is False
    for forced in (True, False):
        monkeypatch.setattr(opt, "USE_F32_KERNELS", forced)
        assert opt._f32_mode() is forced
