"""The port's plain AES-256-GCM (minio_tpu_torch/ops/aes_gcm.py, the CPU
path and the yardstick of kernels C and D) and its AESGCM
(crypto/aead.py) against `cryptography`'s AESGCM, which minio_tpu seals
with, byte for byte (tolerance 0): at the plaintext lengths, AADs and
batches of phase 3 of chip_smoke.py, with tampered packages, and at
the smoke's known answers. The largest batch (4,097 packages) runs with
short packages here: the plain version on the CPU takes seconds a
16 MiB of packages.
"""

import json
import struct

import numpy as np
import pytest
import torch
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
