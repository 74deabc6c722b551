"""Giant-region phasing with the reads axis sharded over the device mesh.

The reference runs each region's ``phase()`` single-threaded inside one rayon
worker (thread.rs:133, phase.rs:1087-1296); a pathologically deep locus
(tens of thousands of overlapping reads over hundreds of SNPs) therefore
serialises on one core. Here such regions are routed to
``sharded_cross_optimize`` (parallel/mesh.py): the [K, I] fragment matrix is
row-sharded across the mesh's "reads" axis, the sigma half-step stays
row-local, and the (delta, eta) column reductions ride psum across devices — the
sequence-parallel analog for coordinate ascent.

Algorithm structure mirrors ``optimize._phase_region_padded_impl``'s
iterative path exactly (ascent → host block flips → perturbation schedule,
phase.rs:1123-1294); only the ascent executions are device-sharded, and the
perturbation loop runs on the host with a seeded numpy stream (same schedule
shape: ``I//4 + 1`` rounds of {10% SNP resets, ascend, keep-best, 10% read
flips, ascend, keep-best}).

Routing is automatic from ``phase_region`` when a region's padded cell count
reaches LONGCALLR_GIANT_CELLS (default 2**26) and the default backend has
more than one device; see ``reads_mesh``.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Tuple

from .. import _jaxcfg  # noqa: F401  (x64 before any trace)
import jax
import jax.numpy as jnp
import numpy as np

from ..config import CallerConfig
from ..ops.candidates import CandidateSet
from ..phasing.fragments import FragmentMatrix
from ..phasing.kernels import CellTables, make_cell_tables_np

f64 = jnp.float64

# padded-cell threshold above which the iterative path is reads-sharded
GIANT_CELLS = int(os.environ.get("LONGCALLR_GIANT_CELLS", str(1 << 26)))


@lru_cache(maxsize=None)
def _sharded_ascent_cached(mesh, with_genotype: bool, keep_conserved: bool):
    """One jitted shard_map ascent per (mesh, flags): without this every
    giant region rebuilt two fresh closures whose jit wrappers never hit
    JAX's in-memory cache — each region re-traced both programs."""
    from .mesh import sharded_cross_optimize
    return sharded_cross_optimize(mesh, with_genotype=with_genotype,
                                  keep_conserved=keep_conserved)


@lru_cache(maxsize=1)
def reads_mesh() -> Optional[jax.sharding.Mesh]:
    """1-D mesh ("reads",) over the largest power-of-two prefix of THIS
    PROCESS's devices; None when only one is available.

    local_devices, not devices: in a multi-process pod each process phases
    its own region shard independently, so a giant region's shard_map must
    run on devices this process can address — a global mesh would dispatch
    onto peers' chips (raising, or desyncing since each process routes
    different regions at different times)."""
    devs = jax.local_devices()
    n = 1 << (len(devs).bit_length() - 1)
    if n < 2:
        return None
    return jax.sharding.Mesh(np.asarray(devs[:n]), ("reads",))


def _np_matvec_objective(ct_np: CellTables, sigma, delta, eta,
                         read_mask, site_mask) -> float:
    """Host overall log10 probability in matvec form (phase.rs:257-276;
    algebra as kernels_fast.py: term = lerr + diff*(1 + p*x)/2)."""
    m = site_mask[None, :] & ct_np.exists
    diff = np.where(m, ct_np.l1m - ct_np.lerr, 0.0)
    lerr_m = np.where(m, ct_np.lerr, 0.0)
    dp = diff * ct_np.p
    u = np.where(eta == 0, delta, 0.0)
    v = np.where(eta == 0, 0.0, eta)
    per_read = (lerr_m.sum(axis=1) + 0.5 * diff.sum(axis=1)
                + 0.5 * (sigma * (dp @ u) + (dp @ v)))
    return float(np.where(read_mask, per_read, 0.0).sum())


def phase_region_sharded(frags: FragmentMatrix, cands: CandidateSet,
                         cfg: CallerConfig, seed: int,
                         apply_downsampling: bool = False,
                         mesh: Optional[jax.sharding.Mesh] = None):
    """Full iterative ``phase()`` for one giant region with reads-sharded
    ascent. Returns a padded PhaseState (caller slices to true sizes),
    matching ``optimize._phase_region_padded`` semantics."""
    from ..phasing.kernels import TIE_TOL
    from ..phasing.optimize import (PhaseState, _bucket, block_flip_pass,
                                    compute_ld_blocks, init_genotype,
                                    init_haplotypes_ld)
    mesh = mesh or reads_mesh()
    assert mesh is not None, "phase_region_sharded needs a multi-device mesh"
    n_shards = mesh.devices.size

    K0, I0 = frags.p.shape
    I = I0
    K = max(_bucket(max(1, K0)), n_shards)   # rows divisible across shards
    I_pad = _bucket(max(1, I0))
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, seed & 0x7FFFFFFF]))

    padKI = lambda a: np.pad(a, ((0, K - K0), (0, I_pad - I0)))
    padK = lambda a, v=0: np.pad(a, (0, K - K0), constant_values=v)
    padI = lambda a, v=0: np.pad(a, (0, I_pad - I0), constant_values=v)
    ct_np = make_cell_tables_np(padKI(frags.p), padKI(frags.baseq))
    site_mask_np = padI(cands.for_phasing)
    ds = frags.downsampled if apply_downsampling else np.ones(K0, bool)
    read_base_np = padK(frags.for_phasing & ds)
    eta0 = padI(init_genotype(cands), 1).astype(np.float64)

    ld = compute_ld_blocks(cands, frags)
    delta0, conserved_np = init_haplotypes_ld(cands, ld, rng)
    delta0 = np.pad(delta0, (0, I_pad - I), constant_values=1).astype(np.float64)
    conserved_np = np.pad(conserved_np, (0, I_pad - I))
    sigma0 = np.where(rng.random(K) < 0.5, -1.0, 1.0)
    sigma0 = np.where(read_base_np, sigma0, 0.0)

    # device-resident operands (sharded by the shard_map in_specs on entry;
    # compact form — each shard expands its own rows). Accelerator meshes
    # take the joint 1-byte/cell transfer (kernels.pack_cells_np).
    if mesh.devices.flat[0].platform != "cpu":
        from ..phasing.kernels import pack_cells_np, unpack_cells
        p8_d, q8_d = unpack_cells(jnp.asarray(pack_cells_np(
            padKI(frags.p), padKI(frags.baseq))))
    else:
        p8_d = jnp.asarray(padKI(frags.p))
        q8_d = jnp.asarray(padKI(frags.baseq).astype(np.uint8))
    rb_d = jnp.asarray(read_base_np)
    sm_d = jnp.asarray(site_mask_np)
    cons_d = jnp.asarray(conserved_np)
    fn_keep = _sharded_ascent_cached(mesh, False, True)
    fn_free = _sharded_ascent_cached(mesh, False, False)

    def ascend(fn, sigma, delta, eta) -> Tuple[PhaseState, float]:
        sg, dl, et, prob = fn(p8_d, q8_d, jnp.asarray(sigma, f64),
                              jnp.asarray(delta, f64), jnp.asarray(eta, f64),
                              rb_d, sm_d, cons_d)
        return PhaseState(sg, dl, et), float(prob)

    best_st, best_prob = ascend(fn_keep, sigma0, delta0, eta0)

    exists_pad = np.zeros((K, I_pad), dtype=bool)
    exists_pad[:K0, :I] = frags.exists()
    st2 = block_flip_pass(ct_np, best_st, read_base_np, site_mask_np,
                          exists_pad, ld)
    sg2, dl2, et2 = (np.asarray(st2.sigma), np.asarray(st2.delta),
                     np.asarray(st2.eta))
    prob2 = _np_matvec_objective(ct_np, sg2, dl2, et2,
                                 read_base_np & (sg2 != 0), site_mask_np)
    if prob2 > best_prob + TIE_TOL:
        best_st, best_prob = st2, prob2

    # perturbation schedule (phase.rs:1198-1233), host loop + sharded ascents
    n_rounds = I // 4 + 1
    for tidx in range(n_rounds):
        b_sg = np.asarray(best_st.sigma)
        b_dl = np.asarray(best_st.delta)
        b_et = np.asarray(best_st.eta)
        lowv, highv = (1.0, -1.0) if tidx % 2 == 1 else (-1.0, 1.0)
        rg = rng.random(I_pad)
        delta = np.where(rg < 0.1, lowv, np.where(rg >= 0.9, highv, b_dl))
        st1, prob1 = ascend(fn_free, b_sg, delta, b_et)
        if prob1 > best_prob + TIE_TOL:
            best_st, best_prob = st1, prob1
            b_sg = np.asarray(best_st.sigma)
            b_dl = np.asarray(best_st.delta)
            b_et = np.asarray(best_st.eta)
        fl = (rng.random(K) < 0.1) & read_base_np & (b_sg != 0)
        sigma = np.where(fl, -b_sg, b_sg)
        st2, prob2 = ascend(fn_free, sigma, b_dl, b_et)
        if prob2 > best_prob + TIE_TOL:
            best_st, best_prob = st2, prob2
    return best_st
