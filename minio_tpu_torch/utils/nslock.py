"""Process-local namespace locking: per-resource RW locks keyed by
"bucket/object", the local form of MinIO's nsLockMap
(cmd/namespace-lock.go). The port's copy of minio_tpu/utils/nslock.py;
the distributed dsync variant is not ported yet.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class _RWLock:
    """Writer-preferring reader/writer lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self.refs = 0  # managed by NamespaceLock

    def acquire_read(self, timeout: float | None = None) -> bool:
        with self._cond:
            deadline = None
            if timeout is not None:
                deadline = time.monotonic() + timeout
            while self._writer or self._writers_waiting:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining)
            self._readers += 1
            return True

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self, timeout: float | None = None) -> bool:
        with self._cond:
            deadline = None
            if timeout is not None:
                deadline = time.monotonic() + timeout
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return False
                    self._cond.wait(remaining)
                self._writer = True
                return True
            finally:
                self._writers_waiting -= 1

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class NamespaceLock:
    """Keyed RW locks with reference counting so idle keys are dropped."""

    def __init__(self):
        self._mu = threading.Lock()
        self._locks: dict[str, _RWLock] = {}

    def _get(self, key: str) -> _RWLock:
        with self._mu:
            lk = self._locks.get(key)
            if lk is None:
                lk = _RWLock()
                self._locks[key] = lk
            lk.refs += 1
            return lk

    def _put(self, key: str, lk: _RWLock):
        with self._mu:
            lk.refs -= 1
            if lk.refs == 0:
                self._locks.pop(key, None)

    @contextmanager
    def write(self, key: str, timeout: float | None = None):
        lk = self._get(key)
        try:
            if not lk.acquire_write(timeout):
                raise TimeoutError(f"write lock timeout on {key}")
            try:
                yield
            finally:
                lk.release_write()
        finally:
            self._put(key, lk)

    @contextmanager
    def read(self, key: str, timeout: float | None = None):
        lk = self._get(key)
        try:
            if not lk.acquire_read(timeout):
                raise TimeoutError(f"read lock timeout on {key}")
            try:
                yield
            finally:
                lk.release_read()
        finally:
            self._put(key, lk)
