"""The port's stage executor and buffer pool (minio_tpu_torch.pipeline),
case for case with minio_tpu's tests/test_pipeline.py: ordering, SKIP and
backpressure; no pool growth in steady state; prompt cancellation when a
stage fails mid-stream; source errors and external cancellation; the
drop hook at most once an item; and no stage thread outliving run() or
results(), on success, on error and on cancellation, checked with
threading.enumerate(). One case runs minio_tpu's Pipeline beside the
port's on the same stages."""

import threading
import time

import numpy as np
import pytest

from minio_tpu.pipeline import Pipeline as JaxPipeline
from minio_tpu.pipeline import Stage as JaxStage
from minio_tpu_torch.pipeline import (
    SKIP,
    BufferPool,
    Pipeline,
    PipelineCancelled,
    Stage,
    host_buffer,
    pool_stats_snapshot,
    shared_pool,
    stage_stats_snapshot,
)


def _stage_threads(name: str) -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith(f"mtpu-pipe-{name}-")]


def _assert_no_stage_thread(name: str) -> None:
    # run()/results() join every worker before they return or raise: no
    # grace period is allowed here.
    assert _stage_threads(name) == []


def test_ordering_and_results():
    pipe = Pipeline("order", [Stage("x2", lambda x: x * 2),
                              Stage("inc", lambda x: x + 1)])
    assert list(pipe.results(range(50))) == [x * 2 + 1 for x in range(50)]
    _assert_no_stage_thread("order")


def test_same_outputs_and_counts_as_minio_tpu():
    def stages(mk):
        return [mk("sq", lambda x: x * x, bytes_of=lambda x: 1),
                mk("odd", lambda x: x if x % 2 else SKIP_OF[mk]),
                mk("neg", lambda x: -x)]

    from minio_tpu.pipeline import SKIP as JAX_SKIP
    SKIP_OF = {Stage: SKIP, JaxStage: JAX_SKIP}
    port = Pipeline("same", stages(Stage), queue_depth=2)
    ref = JaxPipeline("same", stages(JaxStage), queue_depth=2)
    assert list(port.results(range(40))) == list(ref.results(range(40)))
    assert {n: (s["items"], s["bytes"]) for n, s in
            port.stage_stats().items()} == \
        {n: (s["items"], s["bytes"]) for n, s in ref.stage_stats().items()}


def test_skip_filters_items():
    pipe = Pipeline("skip", [Stage("odd", lambda x: x if x % 2 else SKIP)])
    assert list(pipe.results(range(10))) == [1, 3, 5, 7, 9]
    assert pipe.stage_stats()["odd"]["items"] == 5


def test_backpressure_bounds_in_flight():
    """A slow sink stalls the source at the queue bound instead of
    letting it run ahead."""
    produced = []
    release = threading.Event()

    def src():
        for i in range(100):
            produced.append(i)
            yield i

    def slow_sink(x):
        release.wait(5.0)
        return x

    pipe = Pipeline("bp", [Stage("pass", lambda x: x),
                           Stage("sink", slow_sink)], queue_depth=2)
    gen = pipe.results(src())
    first = next(gen)
    assert first == 0
    time.sleep(0.3)  # every chance to run ahead
    # At most the queues (2 + 2 + 2) and one item a stage and feeder.
    assert len(produced) <= 10, f"source ran {len(produced)} items ahead"
    release.set()
    assert [first] + list(gen) == list(range(100))
    assert len(produced) == 100
    _assert_no_stage_thread("bp")


def test_buffer_pool_no_growth_under_steady_state():
    pool = BufferPool(lambda: bytearray(1 << 10), capacity=4, name="t")
    held = [pool.acquire() for _ in range(4)]
    for b in held:
        pool.release(b)
    high_water = pool.stats()["allocated"]
    for _ in range(200):
        pool.release(pool.acquire())
    stats = pool.stats()
    assert stats["allocated"] == high_water, stats
    assert stats["reused"] >= 200 and stats["in_use"] == 0


def test_buffer_pool_never_blocks_after_leak():
    pool = BufferPool(lambda: bytearray(16), capacity=2, name="t")
    _leaked = [pool.acquire(), pool.acquire()]  # never released
    pool.release(pool.acquire())  # must not deadlock
    assert pool.stats()["allocated"] == 3


def test_shared_pool_is_one_per_key_and_host_buffers_on_the_cpu():
    a = shared_pool(("test", 1), lambda: host_buffer((2, 8), "cpu"))
    b = shared_pool(("test", 1), lambda: None)
    assert a is b
    buf = a.acquire()
    assert isinstance(buf, np.ndarray) and buf.shape == (2, 8)
    assert buf.dtype == np.uint8
    a.release(buf)


def test_mid_stream_error_cancels_promptly():
    """First error wins, reaches the caller, and every worker is joined,
    even with upstream blocked on a full queue."""
    def boom(x):
        if x == 7:
            raise RuntimeError("stage exploded")
        return x

    pipe = Pipeline("err", [Stage("pass", lambda x: x), Stage("boom", boom),
                            Stage("after", lambda x: x)], queue_depth=1)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="stage exploded"):
        list(pipe.results(range(10_000)))
    assert time.perf_counter() - t0 < 5.0
    _assert_no_stage_thread("err")
    assert pipe.stage_stats()["boom"]["errors"] == 1
    assert stage_stats_snapshot("err")["err/boom"]["errors"] >= 1


def test_source_error_propagates():
    def src():
        yield 1
        raise OSError("read failed")

    pipe = Pipeline("srcerr", [Stage("pass", lambda x: x)])
    with pytest.raises(OSError, match="read failed"):
        list(pipe.results(src()))
    _assert_no_stage_thread("srcerr")


def test_external_cancel_raises_cancelled():
    def slow(x):
        time.sleep(0.05)
        return x

    pipe = Pipeline("cancel", [Stage("slow", slow)])
    results = []
    with pytest.raises(PipelineCancelled):
        for item in pipe.results(range(1000)):
            results.append(item)
            pipe.cancel()
    assert len(results) >= 1
    _assert_no_stage_thread("cancel")


def test_abandoned_consumer_joins_workers():
    pipe = Pipeline("abandon", [Stage("pass", lambda x: x)], queue_depth=1)
    gen = pipe.results(range(10_000))
    assert next(gen) == 0
    gen.close()  # the consumer hangs up mid-stream
    _assert_no_stage_thread("abandon")


@pytest.mark.parametrize("fail_at", [None, 3, 25])
def test_drop_returns_each_abandoned_buffer_at_most_once(fail_at):
    """Items carry pooled buffers released by the last stage; on a stage
    error every buffer still in flight goes back through drop() exactly
    once, and the pool ends with nothing in use."""
    pool = BufferPool(lambda: bytearray(8), capacity=16, name="drop")
    drops: dict[int, int] = {}

    def drop(item):
        if item[0] is not None:
            drops[id(item)] = drops.get(id(item), 0) + 1
            pool.release(item[0])
            item[0] = None

    def acquire(i):
        return [pool.acquire(), i]

    def middle(item):
        if item[1] == fail_at:
            raise RuntimeError("middle failed")
        return item

    def release(item):
        pool.release(item[0])
        item[0] = None
        return item[1]

    pipe = Pipeline("drop", [Stage("acquire", acquire),
                             Stage("middle", middle),
                             Stage("release", release)],
                    queue_depth=2, pools=[pool], drop=drop)
    if fail_at is None:
        assert pipe.run(range(40)) == 40
        assert drops == {}
    else:
        with pytest.raises(RuntimeError, match="middle failed"):
            pipe.run(range(40))
        assert drops and set(drops.values()) == {1}
    assert pool.stats()["in_use"] == 0
    assert pool_stats_snapshot()["drop"]["in_use"] == 0
    _assert_no_stage_thread("drop")


def test_overlap_beats_serial_sum():
    """3 stages x 8 items x 40 ms of sleep are 960 ms back to back; the
    stages overlap to about (8 + 2) x 40 ms."""
    def mk(name):
        return Stage(name, lambda x: (time.sleep(0.04), x)[1])

    pipe = Pipeline("overlap", [mk("a"), mk("b"), mk("c")], queue_depth=1)
    serial = 8 * 3 * 0.04
    wall = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        assert pipe.run(range(8)) == 8
        wall = min(wall, time.perf_counter() - t0)
        if wall < serial * 0.85:
            break
    assert wall < serial * 0.85, (wall, serial)
    for name in ("a", "b", "c"):
        assert pipe.stage_stats()[name]["items"] == 8
        assert pipe.stage_stats()[name]["busy_s"] >= 8 * 0.04 * 0.8
