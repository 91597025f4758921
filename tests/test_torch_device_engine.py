"""minio_tpu_torch.erasure.device_engine against minio_tpu's device engine
(JAX on the CPU): the encode (parity + digests of all k+m shards) and
reconstruct (rebuilt shards + their digests) batches must be byte-equal,
the caller's host buffer must stay intact, and each batch must count as
one dispatch."""

import numpy as np
import pytest
import torch

from minio_tpu.erasure import device_engine as jde
from minio_tpu_torch.erasure import device_engine

# The suite runs in parallel worker processes: keep torch's intra-op
# thread pool from spinning on every core beside them.
torch.set_num_threads(1)

GEOMETRIES = [(2, 2), (8, 4), (12, 4)]


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_encode_async_matches_jax_engine(k, m):
    rng = np.random.default_rng(k * 31 + m)
    blocks = rng.integers(0, 256, size=(3, k, 333), dtype=np.uint8)
    before = blocks.copy()
    parity_h, digests_h = device_engine.for_geometry(
        k, m, device="cpu").encode_async(blocks, with_hashes=True)
    parity, digests = np.asarray(parity_h), np.asarray(digests_h)
    assert parity.shape == (3, m, 333) and digests.shape == (3, k + m, 32)
    jp, jd = jde.for_geometry(k, m).encode_async(blocks.copy(),
                                                 with_hashes=True)
    assert np.array_equal(parity, np.asarray(jp))
    assert np.array_equal(digests, np.asarray(jd))
    assert np.array_equal(blocks, before)


@pytest.mark.parametrize("k,m,dead", [(8, 4, (0, 5, 9)),
                                      (12, 4, (0, 5, 12, 15))])
def test_reconstruct_async_matches_jax_engine(k, m, dead):
    rng = np.random.default_rng(5)
    present = tuple(i for i in range(k + m) if i not in dead)
    src = rng.integers(0, 256, size=(2, k, 500), dtype=np.uint8)
    before = src.copy()
    codec = device_engine.for_geometry(k, m, device="cpu")
    rebuilt_h, digests_h = codec.reconstruct_async(src, present, dead,
                                                   with_hashes=True)
    jr, jd = jde.for_geometry(k, m).reconstruct_async(
        src.copy(), present, dead, with_hashes=True)
    assert np.array_equal(np.asarray(rebuilt_h), np.asarray(jr))
    assert np.array_equal(np.asarray(digests_h), np.asarray(jd))
    assert np.array_equal(src, before)
    rebuilt, none = codec.reconstruct_async(src, present, dead)
    assert none is None
    assert np.array_equal(np.asarray(rebuilt), np.asarray(jr))


def test_one_dispatch_per_batch():
    codec = device_engine.for_geometry(4, 2, device="cpu")
    blocks = np.random.default_rng(0).integers(0, 256, size=(2, 4, 64),
                                               dtype=np.uint8)
    device_engine.reset_stats()
    for _ in range(3):
        p, d = codec.encode_async(blocks, with_hashes=True)
        np.asarray(p), np.asarray(d)
    codec.reconstruct_async(blocks, (1, 2, 3, 4, 5), (0,))
    stats = device_engine.stats_snapshot()
    assert stats["dispatches"] == 4
    assert stats["launches_gf"] == 4
    assert stats["launches_hash"] == 3


def test_codec_cache_and_device_matrices():
    a = device_engine.for_geometry(8, 4, device="cpu")
    assert device_engine.for_geometry(8, 4, device="cpu") is a
    present, targets = tuple(range(1, 13)), (0,)
    src = np.zeros((1, 8, 16), dtype=np.uint8)
    a.reconstruct_async(src, present, targets)
    n = len(a._mats)
    a.reconstruct_async(src, present, targets)
    assert len(a._mats) == n  # the pattern's matrix is reused


def test_staged_batch_encodes_like_a_host_batch():
    """A batch through HostFeed (on the CPU it passes the host tensor
    through) encodes to the same parity and digests as the host array,
    and minio_tpu's engine agrees."""
    from minio_tpu_torch.ops.host_feed import HostFeed, Staged
    from minio_tpu_torch.pipeline import host_buffer

    k, m = 12, 4
    rng = np.random.default_rng(77)
    blocks = host_buffer((3, k, 333), "cpu")  # a shape JAX compiled above
    blocks[:] = rng.integers(0, 256, size=blocks.shape, dtype=np.uint8)
    staged = HostFeed("cpu")(blocks)
    assert isinstance(staged, Staged) and staged.event is None
    assert staged.nbytes == blocks.nbytes
    codec = device_engine.for_geometry(k, m, device="cpu")
    got = codec.encode_async(staged, with_hashes=True)
    want = codec.encode_async(blocks, with_hashes=True)
    jp, jd = jde.for_geometry(k, m).encode_async(blocks.copy(),
                                                 with_hashes=True)
    for g, w, j in zip(got, want, (jp, jd)):
        assert np.array_equal(np.asarray(g), np.asarray(w))
        assert np.array_equal(np.asarray(g), np.asarray(j))
