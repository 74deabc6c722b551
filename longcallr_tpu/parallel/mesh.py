"""Device-mesh parallelism for the phasing engine.

Replaces the reference's rayon thread-pool data parallelism over regions
(``longcallR/src/thread.rs:52-77``) with JAX sharding over a device mesh:

  * **regions axis** (data parallel): a batch of padded regions is sharded
    across devices; every phasing half-step is a vmapped kernel, so XLA runs
    each device's shard independently — no collectives needed, like the
    reference's embarrassingly-parallel rayon loop but across chips.
  * **reads axis** (the "sequence/tensor parallel" analog): a single huge
    region's fragment matrix is sharded along reads; per-SNP sums become
    `psum` reductions over the reads axis inside ``shard_map``, so one locus
    with hundreds of thousands of reads scales across devices.

Mesh axes: ("regions", "reads").
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

from .. import _jaxcfg  # noqa: F401  (x64 before any trace)
import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..phasing.kernels import CellTables, CompactCells, expand_cells, f64
from ..phasing.kernels import TIE_TOL
from ..phasing.optimize import PhaseState, _sigma_step, _snp_step


def make_mesh(n_regions_axis: Optional[int] = None,
              n_reads_axis: Optional[int] = None,
              devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_regions_axis is None:
        n_reads_axis = n_reads_axis or 1
        n_regions_axis = n // n_reads_axis
    if n_reads_axis is None:
        n_reads_axis = n // n_regions_axis
    assert n_regions_axis * n_reads_axis == n
    return Mesh(devices.reshape(n_regions_axis, n_reads_axis),
                axis_names=("regions", "reads"))


class BatchedRegions(NamedTuple):
    """A bucket of B same-shape padded regions, in compact transfer form
    (2 bytes/cell; the f64 emission tables expand on device inside each
    program — kernels.expand_cells, bit-identical to host expansion)."""

    p: jnp.ndarray         # [B,K,I] int8 in {-1,0,+1}
    q: jnp.ndarray         # [B,K,I] uint8 capped baseq
    read_base: jnp.ndarray  # [B,K] bool
    site_mask: jnp.ndarray  # [B,I] bool
    conserved: jnp.ndarray  # [B,I] bool


def _one_region_step(p, q, read_base, site_mask, conserved,
                     sigma, delta, eta, with_genotype: bool,
                     keep_conserved: bool):
    ct = expand_cells(CompactCells(p, q))
    st = PhaseState(sigma, delta, eta)
    new_sigma, s_inc = _sigma_step(ct, st, read_base, site_mask)
    st = st._replace(sigma=new_sigma)
    new_delta, new_eta, d_inc = _snp_step(ct, st, read_base, site_mask,
                                          conserved, with_genotype,
                                          keep_conserved)
    return new_sigma, new_delta, new_eta, s_inc | d_inc


@partial(jax.jit, static_argnames=("with_genotype", "keep_conserved", "mesh"))
def batched_phase_step(batch: BatchedRegions, sigma, delta, eta,
                       with_genotype: bool = False,
                       keep_conserved: bool = False,
                       mesh: Optional[Mesh] = None):
    """One full coordinate-ascent sweep over a batch of regions.

    With a mesh, the batch axis is sharded over "regions": each device runs
    its own regions' sweep (pure data parallelism, zero collectives)."""
    fn = jax.vmap(partial(_one_region_step, with_genotype=with_genotype,
                          keep_conserved=keep_conserved))
    args = (batch.p, batch.q, batch.read_base,
            batch.site_mask, batch.conserved, sigma, delta, eta)
    if mesh is not None:
        shardings = []
        for a in args:
            spec = P("regions", *([None] * (a.ndim - 1)))
            shardings.append(NamedSharding(mesh, spec))
        args = tuple(jax.lax.with_sharding_constraint(a, s)
                     for a, s in zip(args, shardings))
    return fn(*args)


def read_sharded_snp_sums(mesh: Mesh):
    """Per-SNP masked sums for ONE giant region with the reads axis sharded
    across the mesh's "reads" axis; partial sums are reduced with psum.

    Returns a jitted fn(p, lerr, l1m, sigma, read_mask, site_mask, delta)
    → (s_match, s_flip, s_refe, s_alte, cov), each replicated [I].
    """

    def local_sums(p, lerr, l1m, sigma, read_mask, site_mask, delta):
        m = site_mask[None, :] & (p != 0) & read_mask[:, None]
        x = sigma[:, None] * delta[None, :]
        term = lambda xv: jnp.where(p == xv, l1m, lerr)
        s_match = jnp.where(m, term(x), 0.0).sum(axis=0)
        s_flip = jnp.where(m, term(-x), 0.0).sum(axis=0)
        s_refe = jnp.where(m, term(1.0), 0.0).sum(axis=0)
        s_alte = jnp.where(m, term(-1.0), 0.0).sum(axis=0)
        cov = m.sum(axis=0)
        out = (s_match, s_flip, s_refe, s_alte, cov.astype(jnp.int64))
        return tuple(jax.lax.psum(o, axis_name="reads") for o in out)

    spec_ki = P("reads", None)
    spec_k = P("reads")
    spec_i = P(None)
    fn = shard_map(
        local_sums, mesh=mesh,
        in_specs=(spec_ki, spec_ki, spec_ki, spec_k, spec_k, spec_i, spec_i),
        out_specs=(spec_i,) * 5,
        check_vma=False,
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Batched full-phase programs (bucketed multi-region execution)
# ---------------------------------------------------------------------------

from ..phasing.optimize import selected_loop  # noqa: E402


def _region_ct(batch: BatchedRegions, b=None):
    if b is None:
        return expand_cells(CompactCells(batch.p, batch.q))
    return expand_cells(CompactCells(batch.p[b], batch.q[b]))


@partial(jax.jit, static_argnames=("keep_conserved", "with_genotype", "mesh"))
def batched_cross_optimize(batch: BatchedRegions, sigma, delta, eta,
                           keep_conserved: bool = True,
                           with_genotype: bool = False,
                           mesh: Optional[Mesh] = None):
    """Full ≤21-iteration coordinate ascent, vmapped over a region bucket.
    Returns (sigma, delta, eta, prob[B])."""

    def one(p, q, rb, sm, cons, sg, dl, et):
        from ..phasing.optimize import PhaseState
        # compact cells straight through: the ascent's table builder expands
        # (f64 path) or takes the fused f32 builder (f32 mode) — never
        # materialising f64 [K,I] tables on the f32 path
        st, prob = selected_loop()(CompactCells(p, q), PhaseState(sg, dl, et),
                                   rb, sm, cons, with_genotype,
                                   keep_conserved)
        return st.sigma, st.delta, st.eta, prob

    args = (batch.p, batch.q, batch.read_base,
            batch.site_mask, batch.conserved, sigma, delta, eta)
    if mesh is not None:
        args = tuple(
            jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, P("regions", *([None] * (a.ndim - 1)))))
            for a in args)
    return jax.vmap(one)(*args)


def _batched_perturbation_impl(batch: BatchedRegions, best_sigma, best_delta,
                               best_eta, best_prob, n_rounds, keys,
                               mesh: Optional[Mesh], with_iters: bool,
                               fts=None):
    """Shared body of batched_perturbation_phase and its _stats variant —
    identical programs except for the iteration counter carry. ``fts``:
    optional prebuilt split tables (batched_phase_fused shares ONE build
    across ascent1/flip/schedule — valid because the active-read mask they
    bake in is σ-sign-invariant, so the values are bit-identical to a
    rebuild here)."""
    from ..phasing.optimize import PhaseState

    from ..phasing.optimize import (USE_FAST_KERNELS,
                                    _cross_optimize_fast_loop_it,
                                    _fast_tables_for)
    assert not with_iters or USE_FAST_KERNELS, \
        "iteration accounting needs the fast-kernel ascent"

    B, K = best_sigma.shape
    I = best_delta.shape[1]
    max_rounds = jnp.max(n_rounds)
    # Build the ascent tables ONCE, outside the round loop: building inside
    # the fori body is not hoisted by XLA through vmap and re-gathers them
    # every round. The active-read set is schedule-invariant (σ only flips
    # sign), so the tables are valid for every ascent call of every round.
    # On the fast path the build goes straight from CompactCells (fused f32
    # builder in f32 mode — no [B,K,I] f64 intermediates); the spec path
    # expands the f64 cell tables as before.
    if USE_FAST_KERNELS:
        if fts is None:
            fts = jax.vmap(_fast_tables_for)(
                CompactCells(batch.p, batch.q), batch.read_base, best_sigma,
                batch.site_mask)
        ct_full = None
    else:
        fts = None
        ct_full = expand_cells(CompactCells(batch.p, batch.q))

    # Pre-draw EVERY round's perturbation randoms outside the loop in one
    # batched threefry pass: per-round fold_in/split/uniform inside the fori
    # body is ~6 small kernels/round, each with a fixed launch cost — at
    # 125 rounds that dwarfed the matvec traffic. The (t, b) keys are identical to the in-loop form
    # (fold_in(keys[b], t) → split), so every draw is bit-identical; the
    # static bound R_max = I//4+1 ≥ max(n_rounds) keeps shapes static.
    R_max = I // 4 + 1

    def _draws(kb):
        def per_round(t):
            kr = jax.random.fold_in(kb, t)
            k1, k2 = jax.random.split(kr)
            return (jax.random.uniform(k1, (I,)),
                    jax.random.uniform(k2, (K,)))
        return jax.vmap(per_round)(jnp.arange(R_max))

    rg_all, fl_all = jax.vmap(_draws)(keys)     # [B,R_max,I], [B,R_max,K]

    def one_round(ct_or_ft, rb, sm, cons, b_sigma,
                  b_delta, b_eta, b_prob, active, rg, flraw, flip):
        if USE_FAST_KERNELS:
            ascend = lambda st0: _cross_optimize_fast_loop_it(
                None, st0, rb, sm, cons, with_genotype=False,
                keep_conserved=False, ft=ct_or_ft)
        else:
            ascend = lambda st0: selected_loop()(ct_or_ft, st0, rb, sm, cons,
                                                 False, False) + (jnp.int32(0),)
        b_st = PhaseState(b_sigma, b_delta, b_eta)

        def keep(b_st, b_p, st_new, prob_new):
            better = active & (prob_new > b_p + TIE_TOL)
            sel = lambda a, b: jnp.where(better, a, b)
            return (PhaseState(sel(st_new.sigma, b_st.sigma),
                               sel(st_new.delta, b_st.delta),
                               sel(st_new.eta, b_st.eta)),
                    jnp.where(better, prob_new, b_p))

        lowv = jnp.where(flip, 1.0, -1.0)
        delta = jnp.where(rg < 0.1, lowv,
                          jnp.where(rg >= 0.9, -lowv, b_st.delta))
        st1, prob1, it1 = ascend(b_st._replace(delta=delta))
        b_st, b_prob = keep(b_st, b_prob, st1, prob1)
        fl = (flraw < 0.1) & rb & (b_st.sigma != 0)
        sigma = jnp.where(fl, -b_st.sigma, b_st.sigma)
        st2, prob2, it2 = ascend(b_st._replace(sigma=sigma))
        b_st, b_prob = keep(b_st, b_prob, st2, prob2)
        return b_st.sigma, b_st.delta, b_st.eta, b_prob, it1, it2

    def body(tidx, carry):
        sg, dl, et, pr = carry[:4]
        active = tidx < n_rounds
        flip = jnp.full((B,), (tidx % 2) == 1)
        sg, dl, et, pr, it1, it2 = jax.vmap(one_round)(
            fts if USE_FAST_KERNELS else ct_full,
            batch.read_base, batch.site_mask, batch.conserved, sg, dl, et,
            pr, active, rg_all[:, tidx], fl_all[:, tidx], flip)
        if not with_iters:
            return sg, dl, et, pr
        # the batched (vmapped) while_loop executes max-over-lanes
        # iterations per ascent call, every one moving all B lanes' bytes —
        # that max is the unit the MFU accounting needs
        return sg, dl, et, pr, carry[4] + jnp.max(it1) + jnp.max(it2)

    init = (best_sigma, best_delta, best_eta, best_prob)
    if mesh is not None:
        spec = lambda a: NamedSharding(mesh, P("regions", *([None] * (a.ndim - 1))))
        init = tuple(jax.lax.with_sharding_constraint(a, spec(a)) for a in init)
    if with_iters:
        init = init + (jnp.int32(0),)
    return jax.lax.fori_loop(0, max_rounds, body, init)


@partial(jax.jit, static_argnames=("mesh",))
def batched_perturbation_phase(batch: BatchedRegions, best_sigma, best_delta,
                               best_eta, best_prob, n_rounds, keys,
                               mesh: Optional[Mesh] = None):
    """The perturbation schedule (phase.rs:1198-1233) over a region bucket:
    fori_loop to max(n_rounds) with per-region round masking, vmapped body.

    ``keys`` is a [B, 2] array of per-region PRNGKeys so each region's
    perturbation stream depends only on its own seed — never on which other
    regions share its bucket/wave. This makes batched == per-region and
    --resume byte-identical to an uninterrupted run (phase.rs:1198-1233 uses
    an independent thread_rng per region task).
    Returns (sigma, delta, eta, prob[B]) of the per-region best states."""
    return _batched_perturbation_impl(batch, best_sigma, best_delta, best_eta,
                                      best_prob, n_rounds, keys, mesh,
                                      with_iters=False)


@partial(jax.jit, static_argnames=("mesh",))
def batched_perturbation_phase_stats(batch: BatchedRegions, best_sigma,
                                     best_delta, best_eta, best_prob,
                                     n_rounds, keys,
                                     mesh: Optional[Mesh] = None):
    """batched_perturbation_phase + batch-ascent-iteration accounting for the
    bench's MFU probe: returns (sigma, delta, eta, prob[B], iters) where
    ``iters`` = Σ over ascent calls of the max-over-regions while-loop trip
    count — each such trip streams every region's split Dp twice (rows +
    cols matvecs, kernels_fast.py). States/probs are bit-identical to
    batched_perturbation_phase. Fast-kernel path only."""
    return _batched_perturbation_impl(batch, best_sigma, best_delta, best_eta,
                                      best_prob, n_rounds, keys, mesh,
                                      with_iters=True)


@partial(jax.jit, static_argnames=("mesh",))
def batched_overall_probability(batch: BatchedRegions, sigma, delta, eta,
                                mesh: Optional[Mesh] = None):
    """cal_overall_probability per region of a bucket → prob[B].

    In f32 mode this evaluates via the fused-from-compact split tables
    (matching the scale of the f32 ascent objectives it is compared
    against in the block-flip accept, batch_driver.py); the f64 placements
    keep the exact spec kernel."""
    from ..phasing.kernels import overall_probability
    from ..phasing.optimize import (USE_FAST_KERNELS, _f32_mode,
                                    _fast_tables_for)

    def one(p, q, rb, sm, sg, dl, et):
        rm = rb & (sg != 0)
        if USE_FAST_KERNELS and _f32_mode():
            from ..phasing.kernels_fast import fast_overall_probability32
            ft = _fast_tables_for(CompactCells(p, q), rb, sg, sm)
            return fast_overall_probability32(ft, sg, dl, et)
        ct = expand_cells(CompactCells(p, q))
        return overall_probability(ct, sg, dl, et, rm, sm[None, :])

    args = (batch.p, batch.q, batch.read_base,
            batch.site_mask, sigma, delta, eta)
    if mesh is not None:
        args = tuple(
            jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, P("regions", *([None] * (a.ndim - 1)))))
            for a in args)
    return jax.vmap(one)(*args)


@partial(jax.jit, static_argnames=("mesh",))
def batched_block_flip(batch: BatchedRegions, sigma, delta, eta, block_id,
                       mesh: Optional[Mesh] = None):
    """Device block-flip pass (phase.rs:1298-1394) over a region bucket.

    f32 fast-kernel mode ONLY (the split tables are the operands): callers
    gate on optimize._f32_mode() and run optimize.block_flip_pass on the
    host otherwise. ``block_id`` is [B,I] int32 (−1 = unblocked/padded
    column). Returns (new_sigma, new_delta, prob2[B], margin[B]):
    ``prob2`` scores the flipped state with the SAME expression (and the
    same per-lane tables) as batched_overall_probability's f32 branch, so
    the flip-accept comparison needs no second program/dispatch; a region
    with margin < F32_BF_TOL had a near-tie block decision and must be
    recomputed with the exact host pass (kernels_fast.fast_block_flip32
    docstring)."""
    from ..phasing.kernels_fast import (fast_block_flip32,
                                        fast_overall_probability32)
    from ..phasing.optimize import _f32_mode, _fast_tables_for
    assert _f32_mode(), "device block flip requires the f32 split tables"

    def one(p, q, rb, sm, sg, dl, et, bid):
        ft = _fast_tables_for(CompactCells(p, q), rb, sg, sm)
        sg2, dl2, margin = fast_block_flip32(ft, p, sg, dl, et, sm, bid)
        # the flip never zeroes σ, so ft's active-read set is still exact
        prob2 = fast_overall_probability32(ft, sg2, dl2, et)
        return sg2, dl2, prob2, margin

    args = (batch.p, batch.q, batch.read_base, batch.site_mask,
            sigma, delta, eta, block_id)
    if mesh is not None:
        args = tuple(
            jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, P("regions", *([None] * (a.ndim - 1)))))
            for a in args)
    return jax.vmap(one)(*args)


@partial(jax.jit, static_argnames=("mesh",))
def batched_phase_fused(batch: BatchedRegions, sigma0, delta0, eta0,
                        block_id, n_rounds, keys,
                        mesh: Optional[Mesh] = None):
    """The bucket's ENTIRE iterative phase — first ascent (keep_conserved,
    phase.rs:1132) → block flip + flip score → keep-best → perturbation
    schedule — as ONE device program sharing ONE split-table build (f32
    fast-kernel mode only). It replaces three dispatch roundtrips with one
    and saves two table rebuilds.

    Every stage is the same jitted computation the staged driver runs
    (batched_cross_optimize / batched_block_flip / host keep-best /
    batched_perturbation_phase), composed — outputs are bit-identical
    (asserted in tests), so the driver may choose fused vs staged per
    bucket without affecting results. Returns (sigma, delta, eta, prob[B],
    margin[B]); when any region's margin is inside the f32 envelope the
    caller discards the fused result and reruns the staged path, whose
    host-exact block-flip fallback defines the semantics."""
    from ..phasing.kernels_fast import (fast_block_flip32,
                                        fast_overall_probability32)
    from ..phasing.optimize import (PhaseState, _cross_optimize_fast_loop_it,
                                    _f32_mode, _fast_tables_for)
    assert _f32_mode(), "fused phase requires the f32 split tables"

    args = (batch.p, batch.q, batch.read_base, batch.site_mask,
            batch.conserved, sigma0, delta0, eta0, block_id)
    if mesh is not None:
        args = tuple(
            jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, P("regions", *([None] * (a.ndim - 1)))))
            for a in args)
    p, q, rb, sm, cons, sg0, dl0, et0, bid = args

    # one build serves all three stages: the active-read mask it bakes in
    # (rb & σ≠0) is σ-sign-invariant across the whole sequence
    fts = jax.vmap(_fast_tables_for)(CompactCells(p, q), rb, sg0, sm)

    def one_ascent(ft, rb1, sm1, cons1, sg, dl, et):
        st, prob, _ = _cross_optimize_fast_loop_it(
            None, PhaseState(sg, dl, et), rb1, sm1, cons1,
            with_genotype=False, keep_conserved=True, ft=ft)
        return st.sigma, st.delta, st.eta, prob

    sg1, dl1, et1, prob1 = jax.vmap(one_ascent)(fts, rb, sm, cons,
                                                sg0, dl0, et0)

    def one_flip(ft, p1, sg, dl, et, sm1, bid1):
        sg2, dl2, margin = fast_block_flip32(ft, p1, sg, dl, et, sm1, bid1)
        prob2 = fast_overall_probability32(ft, sg2, dl2, et)
        return sg2, dl2, prob2, margin

    sg2, dl2, prob2, margins = jax.vmap(one_flip)(fts, p, sg1, dl1, et1,
                                                  sm, bid)

    # keep-best (reference scores the flip without re-optimizing,
    # phase.rs:1139-1144) — tie-quantized like the staged driver's host
    # comparison (batch_driver: prob2 > prob1 + TIE_TOL; PARITY #8): when
    # no block flips, prob2 re-scores the SAME state through a different
    # program, so an unquantized > would resolve by summation-order
    # rounding
    better = prob2 > prob1 + TIE_TOL
    best_sg = jnp.where(better[:, None], sg2, sg1)
    best_dl = jnp.where(better[:, None], dl2, dl1)
    best_pr = jnp.where(better, prob2, prob1)

    sgf, dlf, etf, prf = _batched_perturbation_impl(
        batch, best_sg, best_dl, et1, best_pr, n_rounds, keys, mesh,
        with_iters=False, fts=fts)
    return sgf, dlf, etf, prf, margins


@partial(jax.jit, static_argnames=("mesh",))
def batched_enum_cross_optimize(batch: BatchedRegions, sigma0, configs, eta0,
                                mesh: Optional[Mesh] = None):
    """Enumeration path over a bucket: regions axis × configs axis.

    sigma0 [B,C,K] per-region per-config random inits; configs [C,I] shared
    (regions in a bucket have the same logical candidate count); eta0 [B,I].
    Returns (sigma, delta, eta)[B,C,...] and prob[B,C]."""

    def one_cfg(ct, rb, sm, et, sg0, cfg_delta):
        from ..phasing.optimize import PhaseState
        st, prob = selected_loop()(
            ct, PhaseState(sg0, cfg_delta, et), rb, sm,
            jnp.zeros_like(sm), True, False)
        return st.sigma, st.delta, st.eta, prob

    def one_region(p, q, rb, sm, et, sg0):
        # pass the COMPACT cells through (like batched_cross_optimize
        # above): the loop's table dispatch then takes the same fused f32
        # builder the per-region enum path uses
        # (optimize._fast_tables_for / fast_tables32_from_compact), so an
        # enum region's sums — and therefore its mid-ascent decisions —
        # are identical whether it phases alone or in a bucket. The old
        # expand-to-f64-CellTables form routed f32 mode through
        # make_fast_tables32 instead (~1e-4 different sums →
        # bucket-composition-dependent outputs on accelerator sessions).
        ct = CompactCells(p, q)
        return jax.vmap(one_cfg,
                        in_axes=(None,) * 4 + (0, 0)
                        )(ct, rb, sm, et, sg0, configs)

    args = (batch.p, batch.q, batch.read_base,
            batch.site_mask, eta0, sigma0)
    if mesh is not None:
        args = tuple(
            jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, P("regions", *([None] * (a.ndim - 1)))))
            for a in args)
    return jax.vmap(one_region)(*args)


def sharded_cross_optimize(mesh: Mesh, with_genotype: bool = False,
                           keep_conserved: bool = False):
    """Full coordinate ascent for ONE giant region with the reads axis
    sharded over the mesh's "reads" axis (the sequence-parallel analog):
    the σ half-step is row-local, the (δ, η) half-step's column sums and
    the convergence/objective scalars reduce with psum across devices.

    Returns a jitted fn(p8, q8, sigma0, delta0, eta0, read_base,
    site_mask, conserved) → (sigma, delta, eta, prob) with sigma sharded
    like the inputs and δ/η/prob replicated. Cell data arrives in compact
    form (int8 allele + uint8 baseq, 2 bytes/cell — 12× less
    interconnect traffic than shipping the f64 tables); each shard expands only its own
    rows (kernels.expand_cells).
    """
    from ..phasing.kernels import prior_het_log, snp_q_for, snp_qs, sigma_q
    from ..phasing.optimize import PhaseState

    ax = "reads"

    def local(p8, q8, sigma0, delta0, eta0, read_base, site_mask,
              conserved):
        ct = expand_cells(CompactCells(p8, q8))
        p, lerr, l1m, exists = ct.p, ct.lerr, ct.l1m, ct.exists
        m = site_mask[None, :] & exists
        diff = jnp.where(m, l1m - lerr, 0.0)
        lerr_m = jnp.where(m, lerr, 0.0)
        dp = diff * p
        row_b = lerr_m.sum(axis=1)
        row_dif = diff.sum(axis=1)
        row_cells = m.sum(axis=1)
        rm0 = read_base & (sigma0 != 0)
        ms = m & rm0[:, None]
        col_b = jax.lax.psum(jnp.where(ms, lerr, 0.0).sum(axis=0), ax)
        col_dif = jax.lax.psum(jnp.where(ms, diff, 0.0).sum(axis=0), ax)
        col_dp = jax.lax.psum(jnp.where(ms, dp, 0.0).sum(axis=0), ax)
        cov = jax.lax.psum(ms.sum(axis=0), ax)

        def sigma_step(st):
            u = jnp.where(st.eta == 0, st.delta, 0.0)
            v = jnp.where(st.eta == 0, 0.0, st.eta)
            du = dp @ u
            dv = dp @ v
            base = row_b + 0.5 * row_dif + 0.5 * dv
            lp, lm = base + 0.5 * du, base - 0.5 * du
            upd = rm0 & (row_cells > 0)
            q, qn = sigma_q(lp, lm, st.sigma)
            # tie-quantized flip + exact per-element continue flag
            # (kernels.TIE_TOL); rows are sharded, so psum the flip count
            flip = upd & (qn > q + TIE_TOL)
            new_sigma = jnp.where(flip, -st.sigma, st.sigma)
            inc = jax.lax.psum(flip.sum(), ax) > 0
            return new_sigma, inc

        def snp_step(st):
            dts = jax.lax.psum(dp.T @ jnp.where(rm0, st.sigma, 0.0), ax)
            base = col_b + 0.5 * col_dif
            half = 0.5 * st.delta * dts
            sums = (base + half, base - half, base + 0.5 * col_dp,
                    base - 0.5 * col_dp, cov)
            q1, q2, q3, q4 = snp_qs(*sums)
            upd = site_mask & (cov > 0)
            if keep_conserved:
                upd &= ~conserved
            if with_genotype:
                mx = jnp.maximum(jnp.maximum(q1, q2), jnp.maximum(q3, q4))
                pick = jnp.where(q1 >= mx - TIE_TOL, 0,
                                 jnp.where(q2 >= mx - TIE_TOL, 1,
                                           jnp.where(q3 >= mx - TIE_TOL, 2, 3)))
            else:
                het = st.eta == 0
                pick = jnp.where(het, jnp.where(q2 > q1 + TIE_TOL, 1, 0),
                                 jnp.where(q4 > q3 + TIE_TOL, 3, 2))
            new_delta = jnp.where(upd & (pick == 1), -st.delta, st.delta)
            new_eta = jnp.where(
                upd, jnp.where(pick <= 1, 0.0,
                               jnp.where(pick == 2, 1.0, -1.0)), st.eta)
            # cols are replicated across shards: local change flag is global
            changed = ((new_delta != st.delta) | (new_eta != st.eta)).any()
            return new_delta, new_eta, changed

        def cond(carry):
            st, it, go = carry
            return go & (it < 21)

        def body(carry):
            st, it, _ = carry
            sg, s_inc = sigma_step(st)
            st = st._replace(sigma=sg)
            dl, et, d_inc = snp_step(st)
            st = st._replace(delta=dl, eta=et)
            return st, it + 1, s_inc | d_inc

        st0 = PhaseState(sigma0, delta0, eta0)
        st, _, _ = jax.lax.while_loop(cond, body,
                                      (st0, jnp.int32(0), jnp.bool_(True)))
        # objective (matvec form), psum over shards
        u = jnp.where(st.eta == 0, st.delta, 0.0)
        v = jnp.where(st.eta == 0, 0.0, st.eta)
        per_read = (row_b + 0.5 * row_dif
                    + 0.5 * (st.sigma * (dp @ u) + (dp @ v)))
        prob = jax.lax.psum(jnp.where(rm0, per_read, 0.0).sum(), ax)
        return st.sigma, st.delta, st.eta, prob

    spec_ki = P(ax, None)
    spec_k = P(ax)
    spec_i = P(None)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(spec_ki, spec_ki, spec_k, spec_i, spec_i,
                  spec_k, spec_i, spec_i),
        out_specs=(spec_k, spec_i, spec_i, P()),
        check_vma=False,
    )
    return jax.jit(fn)
