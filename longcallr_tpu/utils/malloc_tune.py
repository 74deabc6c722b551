"""glibc malloc tuning for this deployment environment.

A first-touch page fault is expensive on virtualised hosts, so a fresh
large mapping streams far slower than warm memory. By default glibc serves
big allocations via mmap and returns them on free, so every large numpy
temporary re-faults its pages. Raising M_MMAP_THRESHOLD and disabling trim
keeps those blocks on the (warm) heap.

Call ``tune()`` once at process start; it is idempotent and silently a
no-op where glibc/mallopt is unavailable.
"""

from __future__ import annotations

import ctypes
import ctypes.util

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3

_done = False


def tune(mmap_threshold: int = 1 << 30, trim_threshold: int = 1 << 30) -> bool:
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        ok1 = libc.mallopt(M_MMAP_THRESHOLD, mmap_threshold)
        ok2 = libc.mallopt(M_TRIM_THRESHOLD, trim_threshold)
        _done = bool(ok1 and ok2)
    except Exception:
        _done = False
    return _done


def trim() -> bool:
    """One explicit malloc_trim(0): return freed heap blocks to the OS now.

    tune() disables automatic trimming so freed blocks stay warm; an
    explicit trim is still honored by glibc and is the honest way to reset
    the RSS floor before a memory measurement. Returns True if memory was
    released."""
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        return bool(libc.malloc_trim(0))
    except Exception:
        return False
