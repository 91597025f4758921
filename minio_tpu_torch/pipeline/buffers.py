"""BufferPool: a recycling arena of identical buffers, the counterpart of
minio_tpu/pipeline/buffers.py, with a factory of pinned host buffers.

With stages overlapped, several batches are in flight at once, and a
fresh multi-MiB buffer per batch costs a page-fault pass (and, pinned, a
page-locking call) over the whole allocation. The pool allocates each
buffer once and recycles it: steady-state traffic allocates nothing, and
the `allocated` high-water mark is bounded by the pipeline depth, not
the stream length.

acquire() never blocks: with the freelist empty it allocates a fresh
buffer (and counts it), so a cancelled pipeline that leaks its in-flight
buffers cannot deadlock the next run. release() keeps at most `capacity`
buffers on the freelist; extras are dropped to the garbage collector.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch


class CopyCounters:
    """Per-site byte counters of the copies the hot paths still make
    ("put.pack_copy", "put.source_read", ...), counted once a batch."""

    def __init__(self):
        self._mu = threading.Lock()
        self._sites: dict[str, int] = {}

    def add(self, site: str, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._mu:
            self._sites[site] = self._sites.get(site, 0) + nbytes

    def snapshot(self) -> dict[str, int]:
        with self._mu:
            return dict(self._sites)

    def reset(self) -> None:
        with self._mu:
            self._sites.clear()


COPY = CopyCounters()


def copy_add(site: str, nbytes: int) -> None:
    """Record `nbytes` copied (or freshly materialised) at `site`."""
    COPY.add(site, nbytes)


def host_buffer(shape, device) -> np.ndarray:
    """An uninitialised uint8 host array of `shape` for staging to
    `device`: page-locked (a pinned torch tensor viewed as numpy, so a
    copy to the card can run asynchronously from it) when `device` is a
    CUDA device, plain numpy when it is the CPU. Pinning failure raises:
    there is no pageable fallback on the card."""
    if torch.device(device).type == "cpu":
        return np.empty(shape, dtype=np.uint8)
    return torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()


def pinned_factory(shape, device) -> Callable:
    """A BufferPool factory of host buffers of `shape` for `device`
    (host_buffer: pinned on a CUDA device)."""
    return lambda: host_buffer(shape, device)


class BufferPool:
    """Thread-safe freelist of interchangeable buffers.

    factory   -- zero-arg callable producing one buffer.
    capacity  -- max buffers kept on the freelist; also the expected
                 steady-state allocation count (pipeline depth + in-
                 flight stages).
    name      -- label of the pool's counters.
    """

    def __init__(self, factory: Callable, capacity: int = 4,
                 name: str = "pool"):
        self._factory = factory
        self.capacity = capacity
        self.name = name
        self._free: list = []
        self._mu = threading.Lock()
        # allocated only grows (high-water mark of live buffers); reused
        # counts freelist hits: steady state keeps allocated flat while
        # reused climbs.
        self.allocated = 0
        self.reused = 0
        self.in_use = 0

    def acquire(self):
        with self._mu:
            if self._free:
                buf = self._free.pop()
                self.reused += 1
                self.in_use += 1
                return buf
            self.allocated += 1
            self.in_use += 1
        # Allocated outside the lock: faulting in (or pinning) a
        # multi-MiB buffer must not serialise concurrent acquirers.
        return self._factory()

    def release(self, buf) -> None:
        if buf is None:
            return
        with self._mu:
            self.in_use = max(0, self.in_use - 1)
            if len(self._free) < self.capacity:
                self._free.append(buf)

    def stats(self) -> dict:
        with self._mu:
            return {
                "allocated": self.allocated,
                "reused": self.reused,
                "in_use": self.in_use,
                "free": len(self._free),
                "capacity": self.capacity,
            }


# Process-shared pools keyed by buffer geometry: every PUT of one erasure
# geometry recycles the same arena.
_shared: dict[tuple, BufferPool] = {}
_shared_mu = threading.Lock()


def shared_pool(key: tuple, factory: Callable, capacity: int = 6,
                name: str = "") -> BufferPool:
    """Get-or-create the process-wide pool for `key` (a hashable geometry
    tuple; the factory must make interchangeable buffers for it)."""
    with _shared_mu:
        pool = _shared.get(key)
        if pool is None:
            pool = BufferPool(factory, capacity,
                              name=name or "-".join(map(str, key)))
            _shared[key] = pool
        return pool
