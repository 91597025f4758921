"""The kernels' launch counters (ops/_build.LaunchCounter) stay exact
when many threads launch at once, as the S3 server's request threads do:
N threads x M counts give N * M, for kernel A's and kernel B's counter,
with the interpreter switching threads as often as it can. CPython may
not interleave a bare `n += 1` in practice, so a second test holds the
counter's lock and checks that a count waits for it."""

import sys
import threading

import pytest

from minio_tpu_torch.entry import counters
from minio_tpu_torch.ops import _build, highwayhash_torch, rs_cuda

THREADS, COUNTS = 8, 20_000


@pytest.mark.parametrize("counter", [rs_cuda.LAUNCHES,
                                     highwayhash_torch.LAUNCHES,
                                     _build.LaunchCounter()],
                         ids=["gf_apply", "highwayhash256", "fresh"])
def test_counts_from_many_threads_are_exact(counter):
    saved = counter.value
    counter.reset()
    start = threading.Barrier(THREADS)

    def launch():
        start.wait()
        for _ in range(COUNTS):
            counter.add()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    try:
        assert counter.value == THREADS * COUNTS
    finally:
        counter.reset(saved)


def test_add_waits_for_the_lock():
    counter = _build.LaunchCounter()
    counter._lock.acquire()
    t = threading.Thread(target=counter.add)
    try:
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive() and counter.value == 0
    finally:
        counter._lock.release()
    t.join()
    assert counter.value == 1


def test_entry_counters_read_the_kernels_counts():
    before = counters()
    rs_cuda.LAUNCHES.add(3)
    highwayhash_torch.LAUNCHES.add(5)
    after = counters()
    assert after["kernel_gf_launches"] - before["kernel_gf_launches"] == 3
    assert after["kernel_hash_launches"] - before["kernel_hash_launches"] \
        == 5
    rs_cuda.LAUNCHES.add(-3)
    highwayhash_torch.LAUNCHES.add(-5)
