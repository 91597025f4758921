"""Cauchy Reed-Solomon coding matrices, the port's copy of the matrix
constructors of minio_tpu/ops/cauchy.py.

Over GF(2^8) (poly 0x11D, the field of ops/gf.py) the parity rows take
the evaluation points X = {k..k+m-1} and the data columns Y = {0..k-1};
the Cauchy matrix C[i][j] = 1/(x_i XOR y_j) has every square submatrix
nonsingular, so the systematic stack [I; C] is MDS for any k+m <= 256,
with no k x k inversion to systematize it.

minio_tpu also keeps an XOR schedule of these matrices, its host
engine's way of computing the same product. The port computes every
product with kernel A (ops/rs.apply_gf_matrix), so the schedule is not
copied; the tests use minio_tpu's as the oracle.
"""

from __future__ import annotations

import functools

import numpy as np

from . import gf


@functools.lru_cache(maxsize=None)
def cauchy_parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The (m, k) Cauchy parity block: C[i][j] = 1/((k+i) XOR j)."""
    if data_shards + parity_shards > gf.MAX_SHARDS:
        raise ValueError(
            f"data+parity={data_shards + parity_shards} exceeds "
            f"{gf.MAX_SHARDS}"
        )
    out = np.zeros((parity_shards, data_shards), dtype=np.uint8)
    for i in range(parity_shards):
        for j in range(data_shards):
            out[i, j] = gf.gf_inv((data_shards + i) ^ j)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def cauchy_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """Systematic (k+m, k) coding matrix [I; C]: data shards pass through
    unchanged."""
    eye = np.eye(data_shards, dtype=np.uint8)
    out = np.concatenate(
        [eye, cauchy_parity_matrix(data_shards, parity_shards)]
    )
    out.setflags(write=False)
    return out


def cauchy_reconstruct_matrix(data_shards: int, parity_shards: int,
                              present: list[int],
                              targets: list[int]) -> np.ndarray:
    """(len(targets), k) byte matrix regenerating `targets` from the
    first k `present` shards, the contract of gf.reconstruct_matrix."""
    return _cauchy_recon_cached(data_shards, parity_shards, tuple(present),
                                tuple(targets))


@functools.lru_cache(maxsize=256)
def _cauchy_recon_cached(data_shards: int, parity_shards: int,
                         present: tuple, targets: tuple) -> np.ndarray:
    out = gf.reconstruct_matrix_from(
        cauchy_matrix(data_shards, parity_shards), data_shards, present,
        targets)
    out.setflags(write=False)
    return out
