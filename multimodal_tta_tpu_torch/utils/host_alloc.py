"""Host allocator policy for page-fault-expensive hosts (the port's copy of
``multimodal_tta_tpu/utils/host_alloc.py``).

On lazily-backed VMs (snapshot-restored microVMs, ballooned or
network-backed guest memory) the first touch of each NEW page is served by
the hypervisor at single-digit MB/s, while reuse of already-faulted pages
runs at full DRAM speed. glibc's default policy munmaps every freed
allocation above the mmap threshold (128 KB), so a steady-state data
pipeline that allocates a fresh ~64 MB batch per step (collate stack, dtype
casts, transfer staging) hands its hot pages back to the host each batch
and re-pays the first-touch fault forever — measured on such a host:
np.stack of a batch took 8.5 s cold / 11 ms on reused pages, and the
disk->device serving benchmark ran 5x below its round-2 rate until this
policy was applied.

``retain_host_memory()`` flips glibc (via ``mallopt``) to serve large
allocations from the brk heap and never trim it: pages are faulted once and
reused for the life of the process. The trade is RSS that stays at its
high-water mark — correct for benchmarks, trainers, and serving loops with
uniform allocation sizes; don't call it from short-lived forked helpers.

No reference analogue (torch's CachingAllocator solves the device-side
version of this problem; the host side is new here).
"""

from __future__ import annotations

import ctypes
import sys

# glibc mallopt parameter codes (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_applied: bool | None = None


def retain_host_memory() -> bool:
    """Keep freed large blocks mapped (glibc only). Idempotent.

    Returns True when the policy is active, False on non-glibc platforms or
    if mallopt rejects a parameter (both leave the default policy intact).
    """
    global _applied
    if _applied is not None:
        return _applied
    if not sys.platform.startswith("linux"):
        _applied = False
        return False
    try:
        libc = ctypes.CDLL("libc.so.6")
        ok = (
            libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30) == 1
            and libc.mallopt(_M_MMAP_MAX, 0) == 1
            and libc.mallopt(_M_TRIM_THRESHOLD, 0x7FFFFFFF) == 1
        )
    except OSError:
        ok = False
    _applied = bool(ok)
    return _applied
