"""minio_tpu_torch.ops.gf against minio_tpu.ops.gf: the port's copy of the
host GF(2^8) math must produce the same matrices, accept the JAX package's
bit-matrices as its device state, and reproduce the reference's
erasureSelfTest golden chain (tests/_rs_goldens.py) through the port's
codec on the CPU."""

import numpy as np
import pytest
import torch
import xxhash

from minio_tpu.erasure import registry as jreg
from minio_tpu.ops import gf as jgf
from minio_tpu_torch.erasure import registry
from minio_tpu_torch.erasure.codec import Erasure
from minio_tpu_torch.ops import gf

from _rs_goldens import GOLDEN_XXH64

# The suite runs in parallel worker processes: keep torch's intra-op
# thread pool from spinning on every core beside them.
torch.set_num_threads(1)

GEOMETRIES = [(2, 2), (4, 2), (8, 4), (12, 4), (16, 16)]


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_matrices_match_jax_package(k, m):
    assert np.array_equal(gf.rs_matrix(k, m), jgf.rs_matrix(k, m))
    assert np.array_equal(gf.parity_matrix(k, m), jgf.parity_matrix(k, m))
    bits = gf.bit_matrix(gf.parity_matrix(k, m))
    assert bits.dtype == np.int8 and bits.shape == (8 * m, 8 * k)
    assert np.array_equal(bits, jgf.bit_matrix(jgf.parity_matrix(k, m)))
    rng = np.random.default_rng(k * 100 + m)
    lost = sorted(rng.choice(k + m, size=m, replace=False).tolist())
    present = [i for i in range(k + m) if i not in lost]
    assert np.array_equal(gf.reconstruct_matrix(k, m, present, lost),
                          jgf.reconstruct_matrix(k, m, present, lost))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_to_device_bitmat_takes_jax_package_matrices(k, m):
    np_bits = jgf.bit_matrix(jgf.parity_matrix(k, m))
    t = gf.to_device_bitmat(np_bits, "cpu")
    assert t.dtype == torch.int8 and t.is_contiguous()
    assert np.array_equal(t.numpy(), np_bits)


@pytest.mark.parametrize("lost", [(3,), (0, 5)])
def test_to_device_bitmat_is_contiguous_for_few_rows(lost):
    """A one-row bit-matrix comes out of bit_matrix with column-major
    strides; the kernel's wrapper takes only contiguous tensors."""
    present = [i for i in range(16) if i not in lost]
    np_bits = jgf.bit_matrix(jgf.reconstruct_matrix(12, 4, present,
                                                    list(lost)))
    t = gf.to_device_bitmat(np_bits, "cpu")
    assert t.is_contiguous() and np.array_equal(t.numpy(), np_bits)


@pytest.mark.parametrize("bad", [
    np.zeros((8, 12), dtype=np.int8),          # columns not a multiple of 8
    np.zeros((7, 16), dtype=np.int8),          # rows not a multiple of 8
    np.zeros((8, 8, 1), dtype=np.int8),        # not a matrix
    np.full((8, 16), 2, dtype=np.int8),        # entries not 0/1
    np.zeros((0, 16), dtype=np.int8),          # empty
    np.zeros((8, 16), dtype=np.float32),       # not integer
])
def test_to_device_bitmat_rejects_bad_matrices(bad):
    with pytest.raises(ValueError):
        gf.to_device_bitmat(bad, "cpu")


def _self_test_hash(shards) -> int:
    h = xxhash.xxh64()
    for i, shard in enumerate(shards):
        h.update(bytes([i]))
        h.update(np.asarray(shard).tobytes())
    return h.intdigest()


@pytest.mark.parametrize("k,m", [(2, 2), (4, 2), (8, 4), (12, 2), (5, 6),
                                 (14, 1)])
def test_encode_reproduces_reference_goldens(k, m):
    e = Erasure(k, m, 1 << 20, device="cpu")
    assert _self_test_hash(e.encode_data(bytes(range(256)))) \
        == GOLDEN_XXH64[(k, m)]


def test_registry_dense_entry_matches_jax_registry():
    entry = registry.get(registry.DEFAULT_CODEC)
    jentry = jreg.get(jreg.DEFAULT_CODEC)
    assert (entry.codec_id, entry.wire_algorithm) == \
        (jentry.codec_id, jentry.wire_algorithm) == \
        ("dense-gf8", "rs-vandermonde")
    present, targets = [1, 2, 3, 4, 5, 6, 7, 9, 10, 11], [0, 8]
    assert np.array_equal(entry.reconstruct_matrix(8, 4, present, targets),
                          jentry.reconstruct_matrix(8, 4, present, targets))
    with pytest.raises(KeyError):
        registry.get("bogus-codec")  # unknown: loud, never dense
