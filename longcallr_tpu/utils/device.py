"""Compute-device routing.

Small per-region problems are dispatched to the host CPU backend when the
default device is an accelerator: for tiny tensors the accelerator's
dispatch, transfer and first-compile latency dwarfs the math, exactly like
the small-matrix heuristics in BLAS libraries. Large regions and batched
work go to the default device.

Thresholds: LONGCALLR_MIN_ACCEL_CELLS (candidate kernel, in cells) and
LONGCALLR_MIN_ACCEL_PHASE_WORK (phasing, in cells × rounds).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from .. import _jaxcfg  # noqa: F401  (x64 before any trace)
import jax

log = logging.getLogger("longcallr_tpu")

# Degraded-placement observability (round-2 review): when WORK-based routing
# wants the accelerator but the default backend is CPU (device wedge, missing
# plugin, forced-CPU env), the deep path silently runs ~100x slower with only
# this heuristic deciding. Count every such landing and warn once per process
# so the regression is visible (caller.py copies the count into
# CallerOutputs.n_degraded_placements).
DEGRADED_PLACEMENTS = 0
_degraded_lock = threading.Lock()
_warned_degraded = False


def _note_degraded_placement(work: int) -> None:
    global DEGRADED_PLACEMENTS, _warned_degraded
    with _degraded_lock:
        DEGRADED_PLACEMENTS += 1
        if not _warned_degraded:
            _warned_degraded = True
            log.warning(
                "accelerator-scale phase problem (work=%d >= %d) is running "
                "on the host CPU backend because no accelerator device is "
                "available — expect ~100x slower deep phasing", work,
                MIN_ACCEL_PHASE_WORK)

# Candidate-kernel routing, in cells (16 per padded pileup column). From
# the host-vs-H100 crossover sweep (experiments/arith_intensity.py, PERF.md
# "Bring-up findings (H100)"): warm, the card wins at every size measured
# (2^18 cells up); 2^20 keeps small regions, whose many distinct padded
# shapes would each compile for the card, on the host.
MIN_ACCEL_CELLS = int(os.environ.get("LONGCALLR_MIN_ACCEL_CELLS",
                                     str(1 << 20)))

# Phase-stage routing is WORK-based, not cell-based: the ascent schedule
# costs ~(rounds × iterations) passes over the cell matrix, so a region
# with 2M cells and 129 perturbation rounds is seconds of host CPU work
# while a 2M-cell single pass is milliseconds. Work unit: cells × rounds
# (B·K·I_pad·(I//4+1) for the iterative path; B·2^I·K·I_pad for the
# enumeration path — per-config ascents play the rounds role). From the
# same sweep: phase_region takes 15.6 ms on the card vs 13.7 ms on the
# host at 2^19 work and 28 ms vs 66 ms at 2^22; the curves cross near
# 2^19.3.
MIN_ACCEL_PHASE_WORK = int(os.environ.get("LONGCALLR_MIN_ACCEL_PHASE_WORK",
                                          str(1 << 20)))


def ensure_cpu_backend_registered() -> None:
    """Allow 'cpu' alongside the default platform (call before first jax
    backend initialisation; no-op afterwards or when already present)."""
    try:
        plats = jax.config.jax_platforms
        if plats and "cpu" not in plats:
            jax.config.update("jax_platforms", plats + ",cpu")
    except Exception:
        pass


def small_problem_device(n_cells: int) -> Optional[jax.Device]:
    """CPU device for sub-threshold problems, else None (default device)."""
    if n_cells >= MIN_ACCEL_CELLS:
        return None
    return _cpu_or_none()


def phase_problem_device(work: int) -> Optional[jax.Device]:
    """CPU device for sub-threshold PHASE problems (work = cells × rounds,
    see MIN_ACCEL_PHASE_WORK), else None (default device)."""
    if work >= MIN_ACCEL_PHASE_WORK:
        # wants the accelerator; if the default backend is CPU the problem
        # lands there anyway — surface the silent ~100x degradation
        try:
            if jax.devices()[0].platform == "cpu":
                _note_degraded_placement(work)
        except RuntimeError:
            pass
        return None
    return _cpu_or_none()


def accel_placement() -> bool:
    """True when programs traced HERE will run on an accelerator (same
    placement resolution as optimize._f32_mode's auto: an explicit
    jax.default_device context wins, else the default backend). Gates
    host-side work that only pays off for a device target — e.g. the
    1-byte cell packing for transfer (kernels.pack_cells_np)."""
    try:
        dev = jax.config.jax_default_device
        if dev is not None:
            return dev.platform != "cpu"
        return jax.default_backend() != "cpu"
    except Exception:
        return False


def _cpu_or_none() -> Optional[jax.Device]:
    try:
        default = jax.devices()[0]
        if default.platform == "cpu":
            return None
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


# fixed, git-ignored compile-cache directory inside the checkout (the path
# is part of the cache key, so it must not move between runs)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Enable JAX's persistent compile cache and return its directory:
    exactly ``JAX_COMPILATION_CACHE_DIR`` when that is set, otherwise the
    fixed ``.jax_cache/`` of this checkout."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
