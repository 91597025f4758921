"""GF(2^8) host math: tables, Reed-Solomon matrices and the GF(2)
bit-matrix expansion consumed by the GF-apply kernel.

The field and matrix layout reproduce klauspost/reedsolomon (the library
behind the reference's cmd/erasure-coding.go): field polynomial 0x11D and
a systematic coding matrix derived from a Vandermonde matrix whose top
k x k square is inverted away. Multiplication by a constant is linear
over GF(2), so a byte matrix [R, K] expands to a 0/1 matrix [8R, 8K] and
encode/reconstruct become a GF(2) matrix product with the shard bits.

`to_device_bitmat` is where every such matrix enters the port: it takes
the numpy int8 expansion (this module's or the JAX package's, which are
identical) and returns the device tensor the kernels read.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# x^8 + x^4 + x^3 + x^2 + 1, klauspost/reedsolomon's field polynomial.
FIELD_POLY = 0x11D

MAX_SHARDS = 256  # data+parity ceiling (cmd/erasure-coding.go)


def _gen_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= FIELD_POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP_TABLE, LOG_TABLE = _gen_tables()


def gf_mul(a, b):
    """Elementwise GF(2^8) multiply of uint8 arrays/scalars."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = EXP_TABLE[(LOG_TABLE[a] + LOG_TABLE[b]) % 255]
    return np.where((a == 0) | (b == 0), np.uint8(0), out)


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in GF(2^8)")
    return int(EXP_TABLE[(255 - LOG_TABLE[a]) % 255])


def gf_exp(a: int, n: int) -> int:
    """a**n in GF(2^8), matching klauspost galExp."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) * n) % 255])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product of byte matrices [R,K] x [K,C] -> [R,C]."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    prod = gf_mul(a[:, :, None], b[None, :, :])
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_mat_inv(mat: np.ndarray) -> np.ndarray:
    """Invert a square byte matrix over GF(2^8) by Gauss-Jordan.

    Raises ValueError for a singular matrix (ErrTooFewShards at the
    codec layer)."""
    mat = np.asarray(mat, dtype=np.uint8)
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError("matrix must be square")
    work = np.concatenate([mat, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        nz = np.nonzero(work[col:, col])[0]
        if nz.size == 0:
            raise ValueError("singular matrix over GF(2^8)")
        pivot = col + int(nz[0])
        if pivot != col:
            work[[col, pivot]] = work[[pivot, col]]
        work[col] = gf_mul(work[col], gf_inv(int(work[col, col])))
        for r in range(n):
            if r != col and work[r, col] != 0:
                work[r] ^= gf_mul(work[r, col], work[col])
    return work[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """vm[r, c] = r**c in GF(2^8) (klauspost vandermonde())."""
    out = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            out[r, c] = gf_exp(r, c)
    return out


@functools.lru_cache(maxsize=None)
def rs_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """Systematic (k+m, k) coding matrix identical to klauspost
    buildMatrix: Vandermonde(total, k) times the inverse of its top k x k
    square, so the top k rows are the identity."""
    vm = vandermonde(data_shards + parity_shards, data_shards)
    out = gf_matmul(vm, gf_mat_inv(vm[:data_shards]))
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The (m, k) parity rows of the systematic coding matrix."""
    out = rs_matrix(data_shards, parity_shards)[data_shards:].copy()
    out.setflags(write=False)
    return out


def bit_matrix(mat: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) byte matrix [R, C] into its GF(2) form [8R, 8C].

    Interleaved, LSB-first: output row 8*i + a is bit `a` of output byte
    i; input column 8*j + b is bit `b` of input byte j. Column 8*j+b of
    the block for coefficient c holds the bits of c * 2^b."""
    mat = np.asarray(mat, dtype=np.uint8)
    r, c = mat.shape
    basis = np.uint8(1) << np.arange(8, dtype=np.uint8)
    prod = gf_mul(mat[:, :, None], basis[None, None, :])  # [i, j, b]
    bits = (prod[:, :, :, None] >> np.arange(8, dtype=np.uint8)) & 1
    return bits.transpose(0, 3, 1, 2).reshape(8 * r, 8 * c).astype(np.int8)


def bit_matrix_for(mat: np.ndarray) -> np.ndarray:
    """bit_matrix cached by matrix content; the result is read-only and
    shared between callers."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    return _bit_matrix_cached(mat.shape, mat.tobytes())


@functools.lru_cache(maxsize=512)
def _bit_matrix_cached(shape: tuple, buf: bytes) -> np.ndarray:
    out = bit_matrix(np.frombuffer(buf, dtype=np.uint8).reshape(shape))
    out.setflags(write=False)
    return out


def reconstruct_matrix(data_shards: int, parity_shards: int,
                       present: list[int], targets: list[int]) -> np.ndarray:
    """(len(targets), k) byte matrix M with targets = M @ present[:k].

    `present` lists >= k available shard indices; the first k are used,
    as klauspost's reconstruct() does. Cached: a heal of an N-block part
    asks for the same matrix N times."""
    return _reconstruct_matrix_cached(data_shards, parity_shards,
                                      tuple(present), tuple(targets))


@functools.lru_cache(maxsize=256)
def _reconstruct_matrix_cached(data_shards: int, parity_shards: int,
                               present: tuple, targets: tuple) -> np.ndarray:
    out = reconstruct_matrix_from(rs_matrix(data_shards, parity_shards),
                                  data_shards, present, targets)
    out.setflags(write=False)
    return out


def reconstruct_matrix_from(full: np.ndarray, data_shards: int, present,
                            targets) -> np.ndarray:
    """(len(targets), k) byte matrix M with targets = M @ present[:k], for
    any systematic (k+m, k) coding matrix `full` (dense Vandermonde here,
    Cauchy in ops/cauchy.py)."""
    k = data_shards
    if len(present) < k:
        raise ValueError("need at least dataShards present shards")
    inv = gf_mat_inv(full[list(present[:k])])  # present -> original data
    out = np.zeros((len(targets), k), dtype=np.uint8)
    for t_i, t in enumerate(targets):
        out[t_i] = inv[t] if t < k else gf_matmul(full[t: t + 1], inv)[0]
    return out


def gf_matmul_shards_ref(mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """Numpy oracle: apply byte matrix [R, K] to shards [K, S] -> [R, S]."""
    mat = np.asarray(mat, dtype=np.uint8)
    shards = np.asarray(shards, dtype=np.uint8)
    out = np.zeros((mat.shape[0], shards.shape[-1]), dtype=np.uint8)
    for i in range(mat.shape[0]):
        for j in range(mat.shape[1]):
            out[i] ^= gf_mul(mat[i, j], shards[j])
    return out


def to_device_bitmat(np_bits: np.ndarray, device) -> torch.Tensor:
    """Carry a GF(2) bit-matrix onto `device`.

    `np_bits` is the numpy int8 [8R, 8K] expansion in the interleaved
    order of `bit_matrix` (the JAX package's `ops.gf.bit_matrix` yields
    the same array). Checks the shape and that every entry is 0 or 1,
    then returns a contiguous int8 tensor on `device`."""
    arr = np.asarray(np_bits)
    if arr.ndim != 2 or arr.shape[0] % 8 or arr.shape[1] % 8 \
            or 0 in arr.shape:
        raise ValueError(
            f"bit-matrix must be [8R, 8K] with R, K >= 1, got {arr.shape}"
        )
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"bit-matrix must be integer, got {arr.dtype}")
    if not np.isin(arr, (0, 1)).all():
        raise ValueError("bit-matrix entries must be 0 or 1")
    # A one-row matrix comes out of bit_matrix with column-major strides.
    return torch.tensor(np.ascontiguousarray(arr), dtype=torch.int8).to(device)
