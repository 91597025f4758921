"""The port's plain AES-256-GCM (minio_tpu_torch/ops/aes_gcm.py, the CPU
path and the yardstick of kernels C and D) and its AESGCM
(crypto/aead.py) against `cryptography`'s AESGCM, which minio_tpu seals
with, byte for byte (tolerance 0): at the plaintext lengths, AADs and
batches of phase 3 of chip_smoke.py, with tampered packages, and at
the smoke's known answers. The largest batch (4,097 packages) runs with
short packages here: the plain version on the CPU takes seconds a
16 MiB of packages. Below them, a model of kernels C and D's GHASH
split in plain Python integers, held to `cryptography` and to the
plain version (`-k model`).
"""

import functools
import json
import struct

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM as RefAESGCM

import chip_smoke
from minio_tpu_torch.crypto.aead import AESGCM, InvalidTag
from minio_tpu_torch.ops import aes_gcm, aes_gcm_cuda

torch.set_num_threads(1)

LENGTHS = (0, 1, 15, 16, 17, 32, 12_345, 65_536)
AADS = (b"OEK", struct.pack("<Q", 7),
        json.dumps({"bucket": "smoke"}, sort_keys=True).encode())


def _batch(rng, lengths, aads):
    """Plaintexts, nonces and the back-to-back seal descriptor on the
    CPU."""
    p = len(lengths)
    pts = [rng.bytes(int(n)) for n in lengths]
    nonces = [rng.bytes(12) for _ in range(p)]
    desc = torch.from_numpy(aes_gcm.seal_desc(lengths,
                                              [len(a) for a in aads]))

    def t(b):
        return torch.from_numpy(np.frombuffer(b, dtype=np.uint8).copy())

    return (pts, nonces, desc, t(b"".join(pts)),
            t(b"".join(nonces)).reshape(p, 12), t(b"".join(aads)))


def _want(key, pts, nonces, aads) -> bytes:
    return b"".join(n + RefAESGCM(key).encrypt(n, pt, a)
                    for n, pt, a in zip(nonces, pts, aads))


def _check_batch(key, rng, lengths, aads):
    pts, nonces, desc, data, nonce_t, aad = _batch(rng, lengths, aads)
    n = int(data.numel()) + aes_gcm.OVERHEAD * len(pts)
    wire = aes_gcm.seal_plain(key, data, desc, nonce_t, aad, n)
    want = _want(key, pts, nonces, aads)
    assert bytes(wire.numpy()) == want
    odesc = aes_gcm.open_desc(desc)
    plain, ok = aes_gcm.open_plain(key, wire, odesc, aad, data.numel())
    assert bool(ok.all()) and torch.equal(plain, data)


def test_sbox_and_key_schedule():
    s = aes_gcm.sbox()
    assert (s[0], s[1], s[0x53], s[0xFF]) == (0x63, 0x7C, 0xED, 0x16)
    assert sorted(s) == list(range(256))
    # FIPS-197 A.3: the last word of the AES-256 schedule of 603deb10...
    key = bytes.fromhex("603deb1015ca71be2b73aef0857d7781"
                        "1f352c073b6108d72d9810a30914dff4")
    assert aes_gcm.expand_key(key)[59] == 0x706C631E


def test_aes_block_fips197():
    """FIPS-197 C.3: AES-256 of 00112233...ff under 000102...1f."""
    key = bytes(range(32))
    block = torch.tensor([list(bytes.fromhex(
        "00112233445566778899aabbccddeeff"))], dtype=torch.uint8)
    got = aes_gcm.aes_encrypt_blocks(key, block)
    assert bytes(got[0].numpy()) == bytes.fromhex(
        "8ea2b7ca516745bfeafc49904b496089")


@pytest.mark.parametrize("aad", AADS, ids=("oek", "seq", "kms"))
@pytest.mark.parametrize("length", LENGTHS)
def test_plain_seal_open_equals_cryptography(length, aad):
    rng = np.random.default_rng(length * 7 + len(aad))
    _check_batch(rng.bytes(32), rng, [length], [aad])


def test_every_length_and_aad_in_one_batch():
    rng = np.random.default_rng(3)
    pairs = [(n, a) for n in LENGTHS for a in AADS]
    _check_batch(rng.bytes(32), rng, [p[0] for p in pairs],
                 [p[1] for p in pairs])


@pytest.mark.parametrize("packages", (1, 16, 33, 127, 256))
def test_plain_batches_of_full_packages(packages):
    """Batches as the transforms gather them: full 64 KiB packages, the
    last one 12,345 B, the <Q sequence number as each AAD. 127 is the
    card's batch, all full; 33 the closing one of 256 MiB + 12,345 B."""
    rng = np.random.default_rng(packages)
    last = 65_536 if packages == 127 else 12_345
    lengths = [65_536] * (packages - 1) + [last]
    _check_batch(rng.bytes(32), rng, lengths,
                 [struct.pack("<Q", i) for i in range(packages)])


def test_plain_batch_of_4097_packages():
    rng = np.random.default_rng(4097)
    lengths = [i % 37 for i in range(4097)]
    _check_batch(rng.bytes(32), rng, lengths,
                 [struct.pack("<Q", i) for i in range(4097)])


@pytest.mark.parametrize("part", ("nonce", "ct", "tag", "aad"))
def test_tampered_packages_fail_exactly_where_flipped(part):
    rng = np.random.default_rng(11)
    key = rng.bytes(32)
    lengths = [65_536] * 3 + [12_345]
    aads = [struct.pack("<Q", i) for i in range(4)]
    pts, nonces, desc, data, nonce_t, aad = _batch(rng, lengths, aads)
    n = int(data.numel()) + aes_gcm.OVERHEAD * 4
    wire = aes_gcm.seal_plain(key, data, desc, nonce_t, aad, n)
    bad = (1, 3)
    for p in bad:
        _, ln, aad_off, _, out_off = (int(v) for v in desc[p])
        if part == "aad":
            aad[aad_off] ^= 1
        else:
            wire[{"nonce": out_off + 3, "ct": out_off + 12 + ln - 1,
                  "tag": out_off + 12 + ln}[part]] ^= 0x40
    odesc = aes_gcm.open_desc(desc)
    plain, ok = aes_gcm.open_plain(key, wire, odesc, aad, data.numel())
    assert ok.tolist() == [p not in bad for p in range(4)]
    flat = bytes(plain.numpy())
    for p in range(4):
        off, ln = int(desc[p, 0]), int(desc[p, 1])
        assert flat[off:off + ln] == (bytes(ln) if p in bad else pts[p])
    # cryptography refuses the same packages.
    for p in range(4):
        _, ln, aad_off, aad_ln, out_off = (int(v) for v in desc[p])
        pkg = bytes(wire[out_off:out_off + aes_gcm.OVERHEAD + ln].numpy())
        a = bytes(aad[aad_off:aad_off + aad_ln].numpy())
        if p in bad:
            with pytest.raises(Exception):
                RefAESGCM(key).decrypt(pkg[:12], pkg[12:], a)
        else:
            assert RefAESGCM(key).decrypt(pkg[:12], pkg[12:], a) == pts[p]


@pytest.mark.parametrize("i", range(len(chip_smoke.AES_GCM_KAT)))
def test_known_answers(i):
    """The smoke's known answers hold for cryptography, the plain version
    and the port's AESGCM on the CPU."""
    key, nonce, pt, aad, want = (bytes.fromhex(x)
                                 for x in chip_smoke.AES_GCM_KAT[i])
    assert RefAESGCM(key).encrypt(nonce, pt, aad) == want
    aead = AESGCM(key, "cpu")
    assert aead.encrypt(nonce, pt, aad) == want
    assert aead.decrypt(nonce, want, aad) == pt


def test_aead_one_message_and_invalid_tag():
    rng = np.random.default_rng(5)
    key, nonce = rng.bytes(32), rng.bytes(12)
    aead, ref = AESGCM(key, "cpu"), RefAESGCM(key)
    for pt, aad in ((b"", None), (rng.bytes(32), b"OEK"),
                    (rng.bytes(1000), b'{"a": "b"}')):
        ct = aead.encrypt(nonce, pt, aad)
        assert ct == ref.encrypt(nonce, pt, aad)
        assert aead.decrypt(nonce, ct, aad) == pt
        with pytest.raises(InvalidTag):
            aead.decrypt(nonce, ct, (aad or b"") + b"x")
        with pytest.raises(InvalidTag):
            aead.decrypt(nonce, bytes([ct[0] ^ 1]) + ct[1:], aad)


def test_aead_batches_equal_cryptography():
    rng = np.random.default_rng(6)
    key = rng.bytes(32)
    sizes = [65_536, 65_536, 100, 0]
    pts = [rng.bytes(n) for n in sizes]
    nonces = [rng.bytes(12) for _ in sizes]
    aads = [struct.pack("<Q", i) for i in range(len(sizes))]
    aead = AESGCM(key, "cpu")
    wire = aead.seal_packages(b"".join(pts), sizes, nonces, aads)
    assert wire == _want(key, pts, nonces, aads)
    plain, ok = aead.open_packages(wire, sizes, aads)
    assert plain == b"".join(pts) and ok == [True] * len(sizes)
    bad = bytearray(wire)
    bad[-1] ^= 1  # the last package's tag
    plain, ok = aead.open_packages(bytes(bad), sizes, aads)
    assert ok == [True, True, True, False]


def test_kernel_wrappers_refuse_cpu_tensors():
    """Kernels C and D take CUDA tensors or raise; the dispatching calls
    take the plain version for CPU tensors."""
    rng = np.random.default_rng(7)
    key = rng.bytes(32)
    _, _, desc, data, nonces, aad = _batch(rng, [100], [b"OEK"])
    with pytest.raises(ValueError, match="CUDA"):
        aes_gcm_cuda.seal_cuda(key, data, desc, nonces, aad, 128)
    with pytest.raises(ValueError, match="CUDA"):
        aes_gcm_cuda.open_cuda(key, data, desc, aad, 100)
    before = aes_gcm_cuda.SEAL_LAUNCHES.value
    out = aes_gcm_cuda.seal(key, data, desc, nonces, aad, 128)
    assert aes_gcm_cuda.SEAL_LAUNCHES.value == before  # no launch on CPU
    assert torch.equal(out, aes_gcm.seal_plain(key, data, desc, nonces,
                                               aad, 128))


def test_aead_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AESGCM(bytes(32))


# --- a model of kernels C and D's GHASH split ---------------------------
# Plain Python integers, step for step as csrc/aes_gcm.cu computes: a
# block is the big-endian integer of its 16 bytes (the coefficient of x^0
# in the top bit). With CT = C * 256 the threads of a cluster of C
# blocks, the setup kernel forms H^1..H^64 and H^64, H^128, .. H^CT (by
# doubling with the integer product `_gf_mul`, H^64 by squarings) and the
# nibble tables of H^CT (from H^CT x^j, a shift and a fold); each main
# block builds H^CT's byte tables from them, and each thread its weight
# H^(CT - g) with one product. Thread g of the cluster takes the
# package's blocks g, g + CT, g + 2 CT, ... of the sequence right-aligned
# to a multiple of CT (leading zero blocks), folds them by Horner with the
# byte tables of H^CT, and multiplies its sum by its weight; a block's
# partial is the XOR over its threads, the package's GHASH the XOR over
# the cluster's blocks.

_M32, _M64, _M128 = (1 << 32) - 1, (1 << 64) - 1, (1 << 128) - 1


def _gf_mul_ref(x: int, y: int) -> int:
    """SP 800-38D's multiplication in GF(2^128), bit by bit."""
    z, v = 0, y
    for i in range(128):
        if (x >> (127 - i)) & 1:
            z ^= v
        v = (v >> 1) ^ (0xE1 << 120) if v & 1 else v >> 1
    return z


def _bmul32(x: int, y: int) -> int:
    """The carry-less 32 x 32 -> 64 product from four integer products a
    column with the bits of each operand 4 apart (at most 8 terms a
    column, so no carry reaches the next bit kept)."""
    m = (0x11111111, 0x22222222, 0x44444444, 0x88888888)
    xs = [x & k for k in m]
    ys = [y & k for k in m]
    z = 0
    for r in range(4):  # z_r keeps bits r mod 4
        t = 0
        for i in range(4):
            t ^= xs[i] * ys[(r - i) % 4]
        z |= t & (0x1111111111111111 << r)
    return z


def _clmul64(x: int, y: int) -> int:
    lo = _bmul32(x & _M32, y & _M32)
    hi = _bmul32(x >> 32, y >> 32)
    mid = _bmul32((x ^ (x >> 32)) & _M32, (y ^ (y >> 32)) & _M32) ^ lo ^ hi
    return lo ^ (mid << 32) ^ (hi << 64)


def _gf_mul(a: int, b: int) -> int:
    """The kernels' product: Karatsuba over 9 `_bmul32`, the 255-bit
    product shifted left by one (GCM's reflected order), its low half
    folded back (`_fold`)."""
    lo = _clmul64(a & _M64, b & _M64)
    hi = _clmul64(a >> 64, b >> 64)
    mid = _clmul64((a ^ (a >> 64)) & _M64, (b ^ (b >> 64)) & _M64) ^ lo ^ hi
    w = (lo ^ (mid << 64) ^ (hi << 128)) << 1
    return _fold(w >> 128, w & _M128)


def _fold(top: int, o: int) -> int:
    """top + o x^128 in GCM's field (both 128-bit, reflected): o folded
    back by x^128 = 1 + x + x^2 + x^7, right shifts by 1, 2 and 7, and
    once more for the 7 bits those shifts push out."""
    d = ((o << 127) ^ (o << 126) ^ (o << 121)) & _M128
    return (top ^ o ^ (o >> 1) ^ (o >> 2) ^ (o >> 7)
            ^ d ^ (d >> 1) ^ (d >> 2) ^ (d >> 7))


def _times_xj(c: int, j: int) -> int:
    """c x^j: c shifted right by j, the j bits pushed out folded back."""
    return _fold(c >> j, (c << (128 - j)) & _M128)


def _nibble_tables(c: int) -> list:
    """Entry [k][half][v]: the 4 bits of v at bits 8k + 4 half .. + 3 of
    a block, times c."""
    basis = [_times_xj(c, j) for j in range(128)]
    nib = [[[0] * 16 for _ in range(2)] for _ in range(16)]
    for k in range(16):
        for half in range(2):
            for v in range(16):
                for i in range(4):
                    if (v >> (3 - i)) & 1:
                        nib[k][half][v] ^= basis[8 * k + 4 * half + i]
    return nib


def _gf_sqr(a: int) -> int:
    """a^2: a's bits spread to the even places of 256 (a carry-less square
    has no cross terms), shifted and folded as `_gf_mul`."""
    w = 0
    for p in range(128):
        w |= ((a >> p) & 1) << (2 * p)
    w <<= 1
    return _fold(w >> 128, w & _M128)


def _setup(h: int, ct: int):
    """What the setup kernel writes, and what the main blocks make of it:
    A = H^1..H^64 and B = H^64, H^128, .. H^ct (ct / 64 of them), each by
    doubling with `_gf_mul` (H^64 by six squarings); the byte tables of
    H^ct (entry [k][b]: b in byte k times H^ct) from its nibble tables;
    thread g's weight H^(ct - g) = A[e mod 64] B[e div 64], e = ct - g."""
    a = [0, h]
    for step in (1, 2, 4, 8, 16, 32):
        a += [_gf_mul(a[i], a[step]) for i in range(1, step + 1)]
    h64 = h
    for _ in range(6):
        h64 = _gf_sqr(h64)
    b = [0, h64]
    while len(b) - 1 < ct // 64:
        step = len(b) - 1
        b += [_gf_mul(b[i], b[step]) for i in range(1, step + 1)]
    nib = _nibble_tables(b[ct // 64])
    tables = [[nib[k][0][x >> 4] ^ nib[k][1][x & 15] for x in range(256)]
              for k in range(16)]

    def weight(e: int) -> int:  # H^e, 1 <= e <= ct
        lo, hi = e % 64, e // 64
        if hi == 0:
            return a[lo]
        return b[hi] if lo == 0 else _gf_mul(a[lo], b[hi])

    return weight, tables


def _table_mul(tables, y: int) -> int:
    z = 0
    for k in range(16):
        z ^= tables[k][(y >> (8 * (15 - k))) & 255]
    return z


def _ghash_blocks(aad: bytes, ct: bytes) -> list[int]:
    def blocks(b):
        b = b + bytes(-len(b) % 16)
        return [int.from_bytes(b[i:i + 16], "big")
                for i in range(0, len(b), 16)]
    return blocks(aad) + blocks(ct) + [((len(aad) * 8) << 64)
                                       | (len(ct) * 8)]


def _split_ghash(h: int, xs: list[int], cluster: int, threads: int = 256,
                 setup=None) -> tuple[int, list[int]]:
    """GHASH of blocks xs as the kernel splits it over `cluster` blocks of
    `threads` threads: (the sum, each block's partial)."""
    ct = cluster * threads
    weight, tables = setup or _setup(h, ct)
    n = len(xs)
    k_steps = -(-n // ct)
    pad = k_steps * ct - n
    parts = []
    for c in range(cluster):
        part = 0
        for t in range(threads):
            g = c * threads + t
            y, seen = 0, False
            for k in range(k_steps):
                if seen:
                    y = _table_mul(tables, y)
                j = g + k * ct - pad
                if j < 0:
                    continue
                seen = True
                y ^= xs[j]
            if seen:
                part ^= _gf_mul(y, weight(ct - g))
        parts.append(part)
    total = 0
    for part in parts:
        total ^= part
    return total, parts


@functools.lru_cache(maxsize=None)
def _model_setup(key: bytes, cluster: int):
    h = int.from_bytes(_ecb(key, bytes(16)), "big")
    return h, _setup(h, cluster * aes_gcm_cuda.THREADS)


def _ecb(key: bytes, block: bytes) -> bytes:
    enc = Cipher(algorithms.AES(key), modes.ECB()).encryptor()
    return enc.update(block) + enc.finalize()


def _model_tag(key: bytes, nonce: bytes, ct: bytes, aad: bytes,
               cluster: int) -> tuple[bytes, list[int]]:
    h, setup = _model_setup(key, cluster)
    s, parts = _split_ghash(h, _ghash_blocks(aad, ct), cluster,
                            aes_gcm_cuda.THREADS, setup)
    ej0 = int.from_bytes(_ecb(key, nonce + b"\x00\x00\x00\x01"), "big")
    return (s ^ ej0).to_bytes(16, "big"), parts


_MODEL_KEY = bytes(range(7, 39))


@pytest.mark.parametrize("seed", range(8))
def test_model_product_equals_sp800_38d(seed):
    """The threads' closing product, the setup's shifts and its nibble
    tables, each against SP 800-38D's product."""
    rng = np.random.default_rng(seed)
    a, b = (int.from_bytes(rng.bytes(16), "big") for _ in range(2))
    if seed == 0:
        a = b = _M128  # every column of every partial product full
    assert _gf_mul(a, b) == _gf_mul_ref(a, b) == _gf_mul_ref(b, a)
    for j in (0, 1, 7, 63, 64, 65, 120, 121, 127, 16 * seed + 3):
        assert _times_xj(a, j) == _gf_mul_ref(a, 1 << (127 - j)), j
    assert _gf_sqr(a) == _gf_mul_ref(a, a)


@pytest.mark.parametrize("cluster", aes_gcm_cuda.CLUSTER_SIZES)
def test_model_setup_tables(cluster):
    """The setup's weights are H^e, its byte tables multiply by H^CT."""
    h, (weight, tables) = _model_setup(_MODEL_KEY, cluster)
    ct = cluster * aes_gcm_cuda.THREADS
    want = 0
    for e in range(1, ct + 1):  # H^e by SP 800-38D's product
        want = h if e == 1 else _gf_mul_ref(want, h)
        if e in (1, 2, 63, 64, 65, 127, 128, 129, 255, 256, 257) or e == ct:
            assert weight(e) == want, e
    rng = np.random.default_rng(cluster)
    for _ in range(4):
        y = int.from_bytes(rng.bytes(16), "big")
        assert _table_mul(tables, y) == _gf_mul_ref(y, weight(ct))


def _model_case(length: int, aad: bytes, cluster: int, seed: int):
    rng = np.random.default_rng(seed)
    nonce, pt = rng.bytes(12), rng.bytes(length)
    sealed = RefAESGCM(_MODEL_KEY).encrypt(nonce, pt, aad)
    tag, parts = _model_tag(_MODEL_KEY, nonce, sealed[:-16], aad, cluster)
    assert tag == sealed[-16:]
    # The plain version's tag too.
    desc = torch.from_numpy(aes_gcm.seal_desc([length], [len(aad)]))

    def t(b):
        return torch.from_numpy(np.frombuffer(b, dtype=np.uint8).copy())

    wire = aes_gcm.seal_plain(_MODEL_KEY, t(pt), desc,
                              t(nonce).reshape(1, 12), t(aad),
                              length + aes_gcm.OVERHEAD)
    assert bytes(wire[-16:].numpy()) == tag
    return parts


@pytest.mark.parametrize("cluster", aes_gcm_cuda.CLUSTER_SIZES)
@pytest.mark.parametrize("aad", AADS, ids=("oek", "seq", "kms"))
@pytest.mark.parametrize("length", LENGTHS)
def test_model_split_equals_cryptography(length, aad, cluster):
    """Every length (64 KiB included) and AAD at every cluster size."""
    _model_case(length, aad, cluster, length + len(aad))


@pytest.mark.parametrize("cluster", aes_gcm_cuda.CLUSTER_SIZES)
def test_model_empty_and_aad_only_blocks(cluster):
    """A zero-length message with a 3 B AAD leaves every block of the
    cluster but the last without a GHASH block; an AAD of 300 blocks and
    a 17 B message give the first block AAD only (cluster 2) or nothing;
    lengths whose GHASH blocks end exactly on a multiple of the cluster's
    threads, and one block either side."""
    parts = _model_case(0, b"OEK", cluster, 1)
    assert parts[:-1] == [0] * (cluster - 1)
    _model_case(17, bytes(range(256)) * 18 + bytes(192), cluster, 2)
    ct = cluster * aes_gcm_cuda.THREADS
    for blocks in (ct - 1, ct, ct + 1):  # AAD of 1 block, lengths block
        _model_case(16 * (blocks - 2), b"OEK", cluster, blocks)
