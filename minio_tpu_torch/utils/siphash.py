"""SipHash-2-4 (64-bit), compatible with dchest/siphash as MinIO uses it
for object -> set placement (sipHashMod, cmd/erasure-sets.go): k0/k1 are
the two little-endian u64 halves of the 16-byte deployment id. The port's
copy of minio_tpu/utils/siphash.py.
"""

from __future__ import annotations

import zlib

_MASK = 0xFFFFFFFFFFFFFFFF


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _MASK


def siphash64(k0: int, k1: int, data: bytes) -> int:
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def round_():
        nonlocal v0, v1, v2, v3
        v0 = (v0 + v1) & _MASK
        v1 = _rotl(v1, 13)
        v1 ^= v0
        v0 = _rotl(v0, 32)
        v2 = (v2 + v3) & _MASK
        v3 = _rotl(v3, 16)
        v3 ^= v2
        v0 = (v0 + v3) & _MASK
        v3 = _rotl(v3, 21)
        v3 ^= v0
        v2 = (v2 + v1) & _MASK
        v1 = _rotl(v1, 17)
        v1 ^= v2
        v2 = _rotl(v2, 32)

    n = len(data)
    end = n - (n % 8)
    for off in range(0, end, 8):
        m = int.from_bytes(data[off : off + 8], "little")
        v3 ^= m
        round_()
        round_()
        v0 ^= m

    b = (n & 0xFF) << 56
    tail = data[end:]
    b |= int.from_bytes(tail + b"\x00" * (8 - len(tail)), "little")
    v3 ^= b
    round_()
    round_()
    v0 ^= b
    v2 ^= 0xFF
    for _ in range(4):
        round_()
    return (v0 ^ v1 ^ v2 ^ v3) & _MASK


def siphash_mod(key: str, cardinality: int, deployment_id: bytes) -> int:
    """Object -> erasure-set placement (sipHashMod)."""
    if cardinality <= 0:
        return -1
    k0 = int.from_bytes(deployment_id[0:8], "little")
    k1 = int.from_bytes(deployment_id[8:16], "little")
    return siphash64(k0, k1, key.encode()) % cardinality


def crc_hash_mod(key: str, cardinality: int) -> int:
    """Legacy v1 placement (crcHashMod)."""
    if cardinality <= 0:
        return -1
    return (zlib.crc32(key.encode()) & 0xFFFFFFFF) % cardinality
