"""Bucketed multi-region phasing driver.

Groups prepared regions by padded (K, I) bucket and runs the iterative
phase() path for a whole bucket in three device programs (batched first
ascent → host block-flip → batched perturbation schedule), instead of
~4 dispatches per region. Enumeration-path regions (≤ max_enum_snps
candidates) run through the per-region path, which is already a single
chunked-vmap call and routes to the CPU backend when tiny.

The bucket batch axis is shardable over a device mesh ("regions" axis, see
parallel/mesh.py).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import _jaxcfg  # noqa: F401  (x64 before any trace)
import jax
import jax.numpy as jnp
import numpy as np

from ..config import CallerConfig
from ..ops.candidates import CandidateSet
from ..utils.device import phase_problem_device
from .fragments import FragmentMatrix
from .kernels import TIE_TOL, make_cell_tables_np
from .optimize import (PhaseState, _bucket, block_flip_pass, compute_ld_blocks,
                       init_genotype, init_haplotypes_ld, phase_region)


@dataclass
class _Prepared:
    index: int
    frags: FragmentMatrix
    cands: CandidateSet
    seed: int
    apply_ds: bool


def phase_regions_batched(items: List[Tuple[FragmentMatrix, CandidateSet, int, bool]],
                          cfg: CallerConfig, mesh=None) -> List[Optional[PhaseState]]:
    """Phase many regions; returns per-item PhaseState (true, unpadded
    shapes) in input order. Items with no candidates/fragments → None."""
    out: List[Optional[PhaseState]] = [None] * len(items)
    buckets: Dict[Tuple[int, int], List[_Prepared]] = {}
    enum_buckets: Dict[Tuple[int, int], List[_Prepared]] = {}
    for idx, (frags, cands, seed, apply_ds) in enumerate(items):
        K0, I0 = frags.p.shape
        if I0 == 0 or K0 == 0:
            continue
        if I0 <= cfg.max_enum_snps:
            # enumeration regions batch by (K bucket, exact candidate count):
            # same logical I shares the 2^I config matrix
            enum_buckets.setdefault((_bucket(K0), I0), []).append(
                _Prepared(idx, frags, cands, seed, apply_ds))
            continue
        from ..parallel.giant import GIANT_CELLS
        if _bucket(K0) * _bucket(I0) >= GIANT_CELLS:
            # giant region: keep it out of the padded bucket (one such item
            # would blow the whole batch's footprint) and let phase_region
            # route it — to the reads-sharded ascent when a mesh exists
            out[idx] = phase_region(frags, cands, cfg, seed, apply_ds)
            continue
        key = (_bucket(K0), _bucket(I0))
        buckets.setdefault(key, []).append(
            _Prepared(idx, frags, cands, seed, apply_ds))

    for (K, I0), group in sorted(enum_buckets.items()):
        if len(group) == 1:
            it = group[0]
            out[it.index] = phase_region(it.frags, it.cands, cfg, it.seed,
                                         it.apply_ds)
        else:
            _phase_enum_bucket(group, cfg, K, I0, mesh, out)
    for (K, I_pad), group in sorted(buckets.items()):
        _phase_bucket(group, cfg, K, I_pad, mesh, out)
    return out


def _cells_to_device(p: np.ndarray, bq: np.ndarray, dev, mesh, dp):
    """(p, q) of a bucket → device arrays. Accelerator targets transfer the
    joint 1-byte/cell encoding and unpack on device (bit-exact inverse,
    kernels.pack_cells_np), halving the bucket's host-to-device bytes; CPU
    targets (and CPU meshes) take the direct 2-byte form (packing is pure
    overhead there). Every bucket dispatch passes here once, so this is
    where the buckets placed on an accelerator are counted."""
    from ..utils.device import accel_placement
    from .kernels import pack_cells_np, unpack_cells
    if mesh is not None:
        accel = mesh.devices.flat[0].platform != "cpu"
    else:
        accel = dev is None and accel_placement()
    if accel:
        from ..pipeline.engine import stage_add
        stage_add("phase_buckets_device", 1)
        return unpack_cells(dp(pack_cells_np(p, bq)))
    return dp(p), dp(bq)


def _phase_enum_bucket(group: List[_Prepared], cfg: CallerConfig, K: int,
                       I0: int, mesh, out: List[Optional[PhaseState]]) -> None:
    """Batched 2^I enumeration (phase.rs:1097-1122) for regions sharing the
    same config matrix; chunked over configs to bound memory."""
    from ..parallel.mesh import BatchedRegions, batched_enum_cross_optimize
    from .optimize import enumeration_order

    B = len(group)
    I_pad = _bucket(max(1, I0))
    dev = None   # past the router below, the bucket runs on the default
    if mesh is None:
        C_est = enumeration_order(I0).shape[0]
        # one router call per bucket (degraded-placement counter accuracy)
        dev = phase_problem_device(B * C_est * K * I_pad)
        if dev is not None:
            # sub-threshold on an accelerator session → per-region host path
            # (same rationale as _phase_bucket's early exit)
            _phase_group_host(group, cfg, out)
            return
    p = np.zeros((B, K, I_pad), np.int8)
    bq = np.zeros((B, K, I_pad), np.uint8)
    read_base = np.zeros((B, K), bool)
    site_mask = np.zeros((B, I_pad), bool)
    eta0 = np.ones((B, I_pad), np.float64)
    rngs = []
    for b, it in enumerate(group):
        K0, _ = it.frags.p.shape
        p[b, :K0, :I0] = it.frags.p
        bq[b, :K0, :I0] = it.frags.baseq
        ds = it.frags.downsampled if it.apply_ds else np.ones(K0, bool)
        read_base[b, :K0] = it.frags.for_phasing & ds
        site_mask[b, :I0] = it.cands.for_phasing
        eta0[b, :I0] = init_genotype(it.cands)
        rngs.append(np.random.default_rng(
            np.random.SeedSequence([cfg.seed, it.seed & 0x7FFFFFFF])))
    configs = enumeration_order(I0).astype(np.float64)
    configs = np.pad(configs, ((0, 0), (0, I_pad - I0)), constant_values=1.0)
    C = configs.shape[0]
    sig0 = np.zeros((B, C, K), np.float64)
    for b in range(B):
        s = np.where(rngs[b].random((C, K)) < 0.5, -1.0, 1.0)
        sig0[b] = np.where(read_base[b][None, :], s, 0.0)

    # dev resolved once by the router at the top (None here: mesh path, or
    # the work-based router chose the default device; C == C_est)

    def dp(a):
        a = jnp.asarray(a)
        return jax.device_put(a, dev) if dev is not None else a

    p_d, q_d = _cells_to_device(p, bq, dev, mesh, dp)
    batch = BatchedRegions(
        p=p_d, q=q_d,
        read_base=dp(read_base), site_mask=dp(site_mask),
        conserved=dp(np.zeros((B, I_pad), bool)))

    chunk = max(1, int(2 ** 24 // max(1, B * K * I_pad)))
    chunk = min(C, 1 << (chunk.bit_length() - 1))
    best_prob = np.full(B, -np.inf)
    best = [None] * B
    best_idx = np.full(B, -1)
    all_pr: List[np.ndarray] = []
    for c0 in range(0, C, chunk):
        sg, dl, et, pr = batched_enum_cross_optimize(
            batch, dp(sig0[:, c0:c0 + chunk]),
            dp(configs[c0:c0 + chunk]), dp(eta0), mesh=mesh)
        pr = np.asarray(pr)                      # [B, chunk]
        all_pr.append(pr)
        sg, dl, et = (np.asarray(a) for a in (sg, dl, et))
        for b in range(B):
            # sequential tie-quantized keep-best (kernels.TIE_TOL): first
            # config in enumeration order wins structural ties, independent
            # of summation order — same rule as optimize's enum leg
            for j in range(pr.shape[1]):
                if pr[b, j] > best_prob[b] + TIE_TOL:
                    best_prob[b] = float(pr[b, j])
                    best[b] = (sg[b, j], dl[b, j], et[b, j])
                    best_idx[b] = c0 + j
    for b, it in enumerate(group):
        K0, _ = it.frags.p.shape
        sgb, dlb, etb = best[b]
        # numpy out: the consumer (finalize_region) is a host stage — a
        # jnp.asarray here would bounce the vectors through the accelerator
        out[it.index] = PhaseState(sgb[:K0], dlb[:I0], etb[:I0])

    # f32 safety net, enumeration leg (same contract as the per-region enum
    # path, optimize.py): recompute a region on the host f64 path when the
    # winning state's f64 decision margins are inside the f32 error bound,
    # or when any OTHER config's prob sits within the bound of the winner's
    # — above it included (the sequential TIE_TOL keep-best can leave a
    # later config up to TIE_TOL above the winner; its gap reads negative
    # here and forces the rerun).
    from .optimize import (F32_SAFETY_TOL, USE_FAST_KERNELS, _f32_mode,
                           f64_decision_margin_batched)
    if USE_FAST_KERNELS and _f32_mode() and F32_SAFETY_TOL > 0:
        from ..pipeline.engine import stage_add
        pr_all = np.concatenate(all_pr, axis=1)          # [B, C]
        sgf = np.stack([best[b][0] for b in range(B)])
        dlf = np.stack([best[b][1] for b in range(B)])
        etf = np.stack([best[b][2] for b in range(B)])
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            if _f32_mode():        # forced-f32 env: no exact rerun exists
                return
            margins = np.asarray(f64_decision_margin_batched(
                jnp.asarray(p), jnp.asarray(bq), jnp.asarray(sgf),
                jnp.asarray(dlf), jnp.asarray(etf), jnp.asarray(read_base),
                jnp.asarray(site_mask)))
            for b, it in enumerate(group):
                others = np.delete(pr_all[b], int(best_idx[b]))
                cfg_gap = (best_prob[b] - float(others.max())
                           if others.size else np.inf)
                if min(float(margins[b]), cfg_gap) < F32_SAFETY_TOL:
                    stage_add("phase_safety_recompute", 1)
                    out[it.index] = phase_region(it.frags, it.cands, cfg,
                                                 it.seed, it.apply_ds)


# Accelerator-less sessions: cap the bucket batch axis. The batched CPU
# program is ONE serial XLA while-loop whose every iteration touches all B
# regions until the slowest converges, so convergence coupling makes giant
# buckets waste serial work (measured on the 104k-read workload: one B=32
# bucket ≈ 44 s of phase vs ≈ 12 s when the same regions run as wave-sized
# B≈6 buckets). run()'s wave budget produces small buckets naturally; this
# cap protects call sites that batch a whole shard in one call.
CPU_BUCKET_B_CAP = int(os.environ.get("LONGCALLR_CPU_BUCKET_B_CAP", "6"))


def _accel_session() -> bool:
    """True when the session has any accelerator device (the CPU cap keys
    off the SESSION, not the per-call placement —
    a jax.default_device(cpu) comparator block on an accelerator session
    should behave like the accelerator session it is benchmarked against)."""
    try:
        return jax.devices()[0].platform != "cpu"
    except Exception:
        return False


def _phase_group_host(group: List[_Prepared], cfg: CallerConfig,
                      out: List[Optional[PhaseState]]) -> None:
    """Per-region host path for a sub-threshold bucket group (the
    scaled16-style early exits)."""
    for it in group:
        out[it.index] = phase_region(it.frags, it.cands, cfg, it.seed,
                                     it.apply_ds)


def _phase_bucket(group: List[_Prepared], cfg: CallerConfig, K: int,
                  I_pad: int, mesh, out: List[Optional[PhaseState]]) -> None:
    from ..parallel.mesh import (BatchedRegions, batched_cross_optimize,
                                 batched_perturbation_phase)

    B = len(group)
    dev = None   # past the router below, the bucket runs on the default
    if mesh is None:
        max_rounds = max(it.frags.p.shape[1] // 4 + 1 for it in group)
        # one router call per bucket: it also counts degraded placements
        # (utils/device.py), so calling it again later double-counts
        dev = phase_problem_device(B * K * I_pad * max_rounds)
        if dev is not None:
            # Sub-threshold bucket on an accelerator session: the work-based
            # router picked the host CPU, but the batched XLA program costs
            # ~0.3 s per dispatch on the CPU backend — phase_region (the
            # defining host-exact per-region path, byte-equal by the
            # batched==per-region seed contract) is ~10x faster at this
            # scale (scaled16: 6.2 s → per-region host phasing).
            _phase_group_host(group, cfg, out)
            return
        if not _accel_session() and B > CPU_BUCKET_B_CAP:
            # accelerator-less session: the batch couples convergence
            # (every while-loop iteration touches all B regions until the
            # SLOWEST converges), so giant buckets waste serial CPU work —
            # measured: B=32 single-call shard ~44 s of phase vs ~12 s as
            # wave-sized B≈6 buckets on the same regions. Split; byte-
            # invariant (per-region seed streams).
            for i in range(0, B, CPU_BUCKET_B_CAP):
                _phase_bucket(group[i:i + CPU_BUCKET_B_CAP], cfg, K, I_pad,
                              mesh, out)
            return
    p = np.zeros((B, K, I_pad), np.int8)
    bq = np.zeros((B, K, I_pad), np.uint8)
    read_base = np.zeros((B, K), bool)
    site_mask = np.zeros((B, I_pad), bool)
    conserved = np.zeros((B, I_pad), bool)
    sigma0 = np.zeros((B, K), np.float64)
    delta0 = np.ones((B, I_pad), np.float64)
    eta0 = np.ones((B, I_pad), np.float64)
    n_rounds = np.zeros(B, np.int32)
    lds = []
    region_keys = []
    # pass 1: fill the big cell arrays + masks and START the device
    # transfer — device_put is asynchronous, so the bucket's bytes move
    # WHILE the LD/init host loop below runs
    for b, it in enumerate(group):
        K0, I0 = it.frags.p.shape
        p[b, :K0, :I0] = it.frags.p
        bq[b, :K0, :I0] = it.frags.baseq
        ds = it.frags.downsampled if it.apply_ds else np.ones(K0, bool)
        read_base[b, :K0] = it.frags.for_phasing & ds
        site_mask[b, :I0] = it.cands.for_phasing
        n_rounds[b] = I0 // 4 + 1

    from ..pipeline.engine import stage_add
    _t = time.monotonic()
    # dev resolved once by the router at the top (None here: either the
    # mesh path, or the work-based router chose the default device)

    def dp(a):
        a = jnp.asarray(a)
        return jax.device_put(a, dev) if dev is not None else a

    p_d, q_d = _cells_to_device(p, bq, dev, mesh, dp)
    rb_d, sm_d = dp(read_base), dp(site_mask)
    stage_add("phase_tables", time.monotonic() - _t)

    # pass 2: per-region LD blocks + state init (host BLAS/numpy work that
    # overlaps the in-flight transfer). Each region consumes its OWN rng
    # stream in exactly the order the per-region path does
    # (optimize.py::_phase_region_padded_impl): init_haplotypes_ld →
    # padded-K sigma draw → int64 key draw. This makes batched ==
    # per-region and keeps results independent of which other regions share
    # the bucket (resume/mode invariance).
    for b, it in enumerate(group):
        K0, I0 = it.frags.p.shape
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, it.seed & 0x7FFFFFFF]))
        ld = compute_ld_blocks(it.cands, it.frags)
        lds.append(ld)
        d0, cons = init_haplotypes_ld(it.cands, ld, rng)
        delta0[b, :I0] = d0
        conserved[b, :I0] = cons
        eta0[b, :I0] = init_genotype(it.cands)
        s0 = np.where(rng.random(K) < 0.5, -1.0, 1.0)
        sigma0[b] = np.where(read_base[b], s0, 0.0)
        region_keys.append(jax.random.PRNGKey(
            int(rng.integers(0, np.iinfo(np.int64).max, dtype=np.int64))))

    _t = time.monotonic()
    batch = BatchedRegions(p=p_d, q=q_d, read_base=rb_d, site_mask=sm_d,
                           conserved=dp(conserved))
    stage_add("phase_tables", time.monotonic() - _t)
    _t = time.monotonic()

    from .optimize import USE_FAST_KERNELS as _FK
    from .optimize import _f32_mode as _f32m
    keys = jnp.stack(region_keys)
    bid_np = np.full((B, I_pad), -1, np.int32)
    for b, it in enumerate(group):
        blk = lds[b].block_id
        bid_np[b, :blk.shape[0]] = blk

    sgf = None
    if _FK and _f32m():
        # 0) fused whole-phase program: ascent1 → block flip → keep-best →
        # perturbation schedule in ONE dispatch over one shared table build
        # (mesh.py::batched_phase_fused, bit-identical to the staged
        # sequence below). When any region's block-flip margin is inside
        # the f32 envelope, discard and rerun staged — its host-exact
        # fallback defines the semantics.
        from ..parallel.mesh import batched_phase_fused
        from .kernels_fast import F32_BF_TOL
        sgf_d, dlf_d, etf_d, prf_d, margins = batched_phase_fused(
            batch, dp(sigma0), dp(delta0), dp(eta0), dp(bid_np),
            dp(n_rounds), keys, mesh=mesh)
        if (np.asarray(margins) >= F32_BF_TOL).all():
            sgf, dlf, etf = (np.asarray(a) for a in (sgf_d, dlf_d, etf_d))
            stage_add("phase_fused", time.monotonic() - _t)
            _t = time.monotonic()
        else:
            stage_add("phase_fused_refused", 1)
            # the discarded attempt was still fused work — don't let its
            # wall leak into the staged rerun's phase_ascent1 slice
            stage_add("phase_fused", time.monotonic() - _t)
            _t = time.monotonic()

    if sgf is None:
        # 1) first ascent (keep_conserved=True, phase.rs:1132)
        sg, dl, et, prob1 = batched_cross_optimize(
            batch, dp(sigma0), dp(delta0), dp(eta0),
            keep_conserved=True, with_genotype=False, mesh=mesh)
        sg_np, dl_np, et_np = (np.asarray(a) for a in (sg, dl, et))
        prob1_np = np.asarray(prob1)
        stage_add("phase_ascent1", time.monotonic() - _t)
        _t = time.monotonic()

        # 2) block-flip pass per region against the best-so-far (== ascent)
        # state. In f32 fast-kernel mode the whole bucket runs as ONE device
        # program over the already-resident split tables (mesh.py::
        # batched_block_flip — block decisions have no sequential
        # dependence); regions whose smallest per-block decision margin sits
        # inside the f32 error envelope are recomputed with the exact host
        # pass, so decisions — and therefore outputs — match the host-f64
        # path (the same fail-safe shape as the F32_SAFETY_TOL net). On f64
        # placements the host pass fans out over a thread pool (numpy
        # releases the GIL; per-region results are bit-identical to the
        # serial loop).
        sg2 = sg_np.copy()
        dl2 = dl_np.copy()

        def _flip_one(b: int):
            ct_b = make_cell_tables_np(p[b], bq[b])  # host pass: per-region
            st_b = PhaseState(sg_np[b], dl_np[b], et_np[b])
            st2 = block_flip_pass(ct_b, st_b, read_base[b], site_mask[b],
                                  np.asarray(ct_b.exists), lds[b])
            sg2[b] = np.asarray(st2.sigma)
            dl2[b] = np.asarray(st2.delta)

        prob2_np = None
        if _FK and _f32m():
            from ..parallel.mesh import batched_block_flip
            from .kernels_fast import F32_BF_TOL
            sg2_d, dl2_d, prob2_d, margins = batched_block_flip(
                batch, sg, dl, et, dp(bid_np), mesh=mesh)
            # np.array (copy): the host fallback writes rows in place, and
            # np.asarray of a device array is a read-only view
            sg2 = np.array(sg2_d)
            dl2 = np.array(dl2_d)
            prob2_np = np.array(prob2_d)
            # ~(>=) not (<): NaN margins (e.g. a baseq-0 cell puts NaN in
            # the f32-split lo table) must be treated as UNSAFE and take
            # the exact host pass — the same polarity the fused-path gate
            # uses ((margins >= F32_BF_TOL).all())
            bad = np.flatnonzero(~(np.asarray(margins) >= F32_BF_TOL))
            for b in bad:
                stage_add("phase_blockflip_exact", 1)
                _flip_one(int(b))
            if bad.size:
                # rescore ONLY the host-recomputed regions (their in-kernel
                # prob2 scored the pre-fallback flip). The batched program
                # computes every lane; lanes are numerically independent, so
                # a region's kept value never depends on its bucket-mates.
                from ..parallel.mesh import batched_overall_probability
                pr_re = np.asarray(batched_overall_probability(
                    batch, dp(sg2), dp(dl2), dp(et_np), mesh=mesh))
                prob2_np[bad] = pr_re[bad]
        elif cfg.threads > 1 and B > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(cfg.threads, B)) as ex:
                list(ex.map(_flip_one, range(B)))
        else:
            for b in range(B):
                _flip_one(b)

        # evaluate flipped states (reference scores the flip without
        # re-optimizing, phase.rs:1139-1144) and keep per-region best. The
        # device-flip path already scored the flip inside its program (same
        # expression and tables as the f32 branch here — no second
        # dispatch).
        if prob2_np is None:
            from ..parallel.mesh import batched_overall_probability
            prob2_np = np.asarray(batched_overall_probability(
                batch, dp(sg2), dp(dl2), dp(et_np), mesh=mesh))
        better = prob2_np > prob1_np + TIE_TOL
        best_sg = np.where(better[:, None], sg2, sg_np)
        best_dl = np.where(better[:, None], dl2, dl_np)
        best_prob = np.where(better, prob2_np, prob1_np)
        stage_add("phase_blockflip", time.monotonic() - _t)
        _t = time.monotonic()

        # 3) batched perturbation schedule with per-region round counts and
        # per-region keys (bucket-composition-independent randomness)
        sgf, dlf, etf, prf = batched_perturbation_phase(
            batch, dp(best_sg), dp(best_dl), dp(et_np),
            dp(best_prob.astype(np.float64)), dp(n_rounds), keys, mesh=mesh)
        sgf, dlf, etf = (np.asarray(a) for a in (sgf, dlf, etf))
        stage_add("phase_perturb", time.monotonic() - _t)
        _t = time.monotonic()
    for b, it in enumerate(group):
        K0, I0 = it.frags.p.shape
        out[it.index] = PhaseState(sgf[b, :K0], dlf[b, :I0], etf[b, :I0])

    # f32 safety net (same contract as the per-region path, optimize.py):
    # margins re-checked in exact f64 on the host; near-tie regions are
    # recomputed per-region under the CPU default-device context where auto
    # mode resolves to f64.
    from .optimize import (F32_SAFETY_TOL, USE_FAST_KERNELS, _f32_mode,
                           f64_decision_margin_batched)
    if USE_FAST_KERNELS and _f32_mode() and F32_SAFETY_TOL > 0:
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            if _f32_mode():        # forced-f32 env: no exact rerun exists
                stage_add("phase_safety", time.monotonic() - _t)
                return
            # whole-bucket margins in one host program (matvec-form f64)
            margins = np.asarray(f64_decision_margin_batched(
                jnp.asarray(p), jnp.asarray(bq), jnp.asarray(sgf),
                jnp.asarray(dlf), jnp.asarray(etf), jnp.asarray(read_base),
                jnp.asarray(site_mask)))
            for b, it in enumerate(group):
                # not (>=): a NaN margin means the f64 re-evaluation itself
                # degenerated — recompute, same polarity as the flip gates
                if not margins[b] >= F32_SAFETY_TOL:
                    stage_add("phase_safety_recompute", 1)
                    out[it.index] = phase_region(it.frags, it.cands, cfg,
                                                 it.seed, it.apply_ds)
        stage_add("phase_safety", time.monotonic() - _t)
