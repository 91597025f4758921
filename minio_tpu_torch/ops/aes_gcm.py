"""AES-256-GCM in plain PyTorch: the CPU path of the port's AEAD and the
yardstick of kernels C and D (csrc/aes_gcm.cu). minio_tpu seals with
`cryptography`'s AESGCM; this is its counterpart, byte for byte.

Both functions take a batch of packages that share one key, laid out by
a descriptor `desc` int64 [P, 5] whose row p is
(in_off, length, aad_off, aad_len, out_off):

- `seal_plain` reads package p's plaintext at data[in_off : in_off +
  length] and its AAD at aad[aad_off : aad_off + aad_len], and writes
  nonce (12) || ciphertext || tag (16) at out[out_off:];
- `open_plain` reads nonce || ciphertext || tag at data[in_off:] (length
  is the ciphertext's), checks the tag and writes the plaintext at
  out[out_off:]; a package whose tag fails gets ok = False and zeros.

AES-256 is FIPS-197: the S-box built from the inverse in GF(2^8) and the
affine map, the key schedule on the host (60 words), and the 14 rounds
as uint8 gathers and XORs batched over blocks. CTR starts at
inc32(J0) = nonce || 2; the tag is E(K, nonce || 1) xor GHASH. GHASH
works on GCM's reflected bits (bit 0 of a block is the top bit of byte
0): with every package's blocks right-aligned to n blocks (leading zero
blocks change nothing), GHASH = sum_j X_j * H^(n - j), one float32
product of 0/1 bits with the stacked matrices of multiplication by
H^1..H^n (exact: every sum is below 2^24), then mod 2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NONCE = 12
TAG = 16
OVERHEAD = NONCE + TAG


def _starts(sizes: np.ndarray) -> np.ndarray:
    out = np.zeros(len(sizes), dtype=np.int64)
    np.cumsum(sizes[:-1], out=out[1:])
    return out


def seal_desc(lengths, aad_lengths) -> np.ndarray:
    """The seal descriptor of packages laid back to back: package p's
    plaintext of lengths[p] bytes, its AAD of aad_lengths[p] bytes, and
    its wire package, OVERHEAD bytes longer than its plaintext."""
    lengths = np.asarray(lengths, dtype=np.int64).reshape(-1)
    aad_len = np.asarray(aad_lengths, dtype=np.int64).reshape(-1)
    in_off = _starts(lengths)
    return np.stack([in_off, lengths, _starts(aad_len), aad_len,
                     in_off + OVERHEAD * np.arange(len(lengths))], axis=1)


def open_desc(desc):
    """The open descriptor (numpy or torch, a contiguous copy) of the
    packages that `desc` sealed: each one's wire offset in, its
    plaintext offset out."""
    columns = [4, 1, 2, 3, 0]
    if isinstance(desc, torch.Tensor):
        return desc[:, columns].contiguous()
    return np.ascontiguousarray(desc[:, columns])


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x11B) if a & 0x100 else a


@functools.lru_cache(maxsize=None)
def sbox() -> tuple[int, ...]:
    """FIPS-197's S-box: the inverse in GF(2^8) (0 for 0), then the
    affine map b ^ rotl(b, 1..4) ^ 0x63."""
    exp, log = [0] * 255, [0] * 256
    x = 1
    for i in range(255):  # 3 generates GF(2^8)^*
        exp[i], log[x] = x, i
        x ^= _xtime(x)
    out = []
    for a in range(256):
        b = exp[(255 - log[a]) % 255] if a else 0
        s = b
        for r in range(1, 5):
            s ^= ((b << r) | (b >> (8 - r))) & 0xFF
        out.append(s ^ 0x63)
    return tuple(out)


def expand_key(key: bytes) -> list[int]:
    """AES-256's 60 round-key words, big-endian (FIPS-197 5.2)."""
    if len(key) != 32:
        raise ValueError(f"AES-256 needs a 32-byte key, got {len(key)}")
    s = sbox()
    w = [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(8)]
    rcon = 1
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = int.from_bytes(bytes(s[b] for b in t.to_bytes(4, "big")),
                               "big") ^ (rcon << 24)
            rcon = _xtime(rcon)
        elif i % 8 == 4:
            t = int.from_bytes(bytes(s[b] for b in t.to_bytes(4, "big")),
                               "big")
        w.append(w[i - 8] ^ t)
    return w


# ShiftRows on the column-major state (byte r + 4c is row r, column c).
_SHIFT_ROWS = [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)]


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    s = torch.tensor(sbox(), dtype=torch.uint8, device=device)
    xt = torch.tensor([_xtime(a) & 0xFF for a in range(256)],
                      dtype=torch.uint8, device=device)
    shift = torch.tensor(_SHIFT_ROWS, dtype=torch.long, device=device)
    return s, xt, shift


def _round_keys(key: bytes, device: torch.device) -> torch.Tensor:
    w = expand_key(key)
    rk = b"".join(x.to_bytes(4, "big") for x in w)
    return torch.frombuffer(bytearray(rk), dtype=torch.uint8).to(
        device).reshape(15, 16)


def aes_encrypt_blocks(key: bytes, blocks: torch.Tensor) -> torch.Tensor:
    """E(K, block) of each row of uint8 [N, 16], on its device, 64 Ki
    blocks at a time on the CPU and 1 Mi on the card."""
    dev = blocks.device
    chunk = 1 << 16 if dev.type == "cpu" else 1 << 20
    s_box, xt, shift = _tables(dev)
    rk = _round_keys(key, dev)
    out = torch.empty_like(blocks)
    for lo in range(0, blocks.shape[0], chunk):
        st = blocks[lo:lo + chunk] ^ rk[0]
        for r in range(1, 15):
            st = s_box[st.long()][:, shift]
            if r < 14:
                a = st.view(-1, 4, 4)  # [N, column, row]
                a2 = xt[a.long()]
                r1, r2, r3 = (a.roll(-i, dims=2) for i in (1, 2, 3))
                b1 = a2.roll(-1, dims=2)  # 2 * a[row + 1]
                # MixColumns: 2 a_r ^ 3 a_(r+1) ^ a_(r+2) ^ a_(r+3)
                st = (a2 ^ b1 ^ r1 ^ r2 ^ r3).reshape(-1, 16)
            st = st ^ rk[r]
        out[lo:lo + chunk] = st
    return out


# --- GF(2^128) in GCM's bit order, on 0/1 tensors [..., 128] -----------
# bits[..., i] is the coefficient of x^i: bit 7 - i % 8 of byte i // 8.

_R_BITS = (0, 1, 2, 7)  # x^128 = 1 + x + x^2 + x^7


def _to_bits(blocks: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(7, -1, -1, device=blocks.device,
                          dtype=torch.uint8)
    return ((blocks[..., None] >> shifts) & 1).reshape(
        *blocks.shape[:-1], blocks.shape[-1] * 8)


def _from_bits(bits: torch.Tensor) -> torch.Tensor:
    weights = (1 << torch.arange(7, -1, -1, device=bits.device)).to(
        torch.uint8)
    b = bits.to(torch.uint8).reshape(*bits.shape[:-1], -1, 8)
    return (b * weights).sum(dim=-1, dtype=torch.uint8)


def _times_x(v: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(v)
    out[..., 1:] = v[..., :-1]
    top = v[..., 127]
    for i in _R_BITS:
        out[..., i] ^= top
    return out


def _mul_matrices(c: torch.Tensor) -> torch.Tensor:
    """[N, 128] bits of c -> uint8 [N, 128, 128]: column i is c * x^i, so
    that bits(X * c) = M @ bits(X) mod 2."""
    cols = [c]
    for _ in range(127):
        cols.append(_times_x(cols[-1]))
    return torch.stack(cols, dim=-1)


def _mul_by(x_bits: torch.Tensor, c_bits: torch.Tensor) -> torch.Tensor:
    """X * c for each row of [N, 128] X and one c [128]."""
    m = _mul_matrices(c_bits[None])[0].to(torch.float32)
    acc = x_bits.to(torch.float32) @ m.T
    return (acc.to(torch.int64) & 1).to(torch.uint8)


def _powers(h_bits: torch.Tensor, n: int) -> torch.Tensor:
    """H^1 .. H^n as bits [n, 128], by doubling."""
    pw = h_bits[None]
    while pw.shape[0] < n:
        pw = torch.cat([pw, _mul_by(pw, pw[-1])])
    return pw[:n]


def _be(values: torch.Tensor, width: int) -> torch.Tensor:
    """int64 [N] -> their big-endian bytes uint8 [N, width]."""
    shifts = torch.arange(8 * (width - 1), -1, -8, device=values.device)
    return ((values[:, None] >> shifts) & 0xFF).to(torch.uint8)


def _segments(src: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
              pad_to: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The bytes src[offs[p] : offs[p] + lens[p]] of every p, each padded
    with zeros to a multiple of `pad_to`, back to back: (flat uint8,
    padded lengths)."""
    dev = src.device
    plens = (lens + pad_to - 1) // pad_to * pad_to
    total = int(plens.sum())
    starts = torch.cumsum(plens, 0) - plens
    out = torch.zeros(total, dtype=torch.uint8, device=dev)
    if total:
        seg = torch.repeat_interleave(torch.arange(len(lens), device=dev),
                                      plens)
        pos = torch.arange(total, device=dev) - starts[seg]
        valid = pos < lens[seg]
        idx = (offs[seg] + pos)[valid]
        out[valid] = src[idx]
    return out, plens


def _ghash(h_bits: torch.Tensor, aad: torch.Tensor, desc: torch.Tensor,
           ct: torch.Tensor, ct_offs: torch.Tensor,
           chunk: int = 256) -> torch.Tensor:
    """GHASH_H(A, C) of every package: uint8 [P, 16]. `ct` holds the
    ciphertexts at ct_offs with the lengths in desc[:, 1]."""
    dev = ct.device
    p = desc.shape[0]
    a_pad, a_plen = _segments(aad, desc[:, 2], desc[:, 3], 16)
    c_pad, c_plen = _segments(ct, ct_offs, desc[:, 1], 16)
    lens = torch.cat([_be(desc[:, 3] * 8, 8), _be(desc[:, 1] * 8, 8)], 1)
    nblk = a_plen // 16 + c_plen // 16 + 1
    n = int(nblk.max())
    seq = torch.zeros((p, n, 16), dtype=torch.uint8, device=dev)
    # Right-aligned: package p's blocks end at column n - 1.
    first = n - nblk
    a_seg = torch.repeat_interleave(torch.arange(p, device=dev),
                                    a_plen // 16)
    a_col = first[a_seg] + (torch.arange(len(a_seg), device=dev)
                            - (torch.cumsum(a_plen // 16, 0)
                               - a_plen // 16)[a_seg])
    seq[a_seg, a_col] = a_pad.reshape(-1, 16)
    c_seg = torch.repeat_interleave(torch.arange(p, device=dev),
                                    c_plen // 16)
    c_col = (first + a_plen // 16)[c_seg] + (
        torch.arange(len(c_seg), device=dev)
        - (torch.cumsum(c_plen // 16, 0) - c_plen // 16)[c_seg])
    seq[c_seg, c_col] = c_pad.reshape(-1, 16)
    seq[:, n - 1] = lens
    powers = _powers(h_bits, n)  # H^1 .. H^n
    acc = torch.zeros((p, 128), dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        # Column j takes H^(n - j): powers[n - 1 - j].
        mats = _mul_matrices(powers[n - 1 - torch.arange(lo, hi,
                                                         device=dev)])
        w = mats.permute(0, 2, 1).reshape((hi - lo) * 128, 128)
        xb = _to_bits(seq[:, lo:hi]).reshape(p, (hi - lo) * 128)
        acc += xb.to(torch.float32) @ w.to(torch.float32)
    return _from_bits((acc.to(torch.int64) & 1).to(torch.uint8))


def _check_desc(desc: torch.Tensor, data: torch.Tensor, aad: torch.Tensor,
                nonces: torch.Tensor | None = None) -> None:
    for name, t in (("data", data), ("aad", aad)):
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D uint8, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if desc.dtype != torch.int64 or desc.dim() != 2 or desc.shape[1] != 5:
        raise ValueError(f"desc must be int64 [P, 5], got {desc.dtype} "
                         f"{tuple(desc.shape)}")
    if nonces is not None and (nonces.dtype != torch.uint8 or tuple(
            nonces.shape) != (desc.shape[0], NONCE)):
        raise ValueError(f"nonces must be uint8 [{desc.shape[0]}, 12], got "
                         f"{nonces.dtype} {tuple(nonces.shape)}")


def _keystream(key: bytes, nonces: torch.Tensor, lens: torch.Tensor):
    """(CTR keystream bytes of every package back to back, E(K, J0) of
    each [P, 16], H bits [128])."""
    dev = nonces.device
    p = nonces.shape[0]
    nblk = (lens + 15) // 16
    seg = torch.repeat_interleave(torch.arange(p, device=dev), nblk)
    ctr = torch.arange(len(seg), device=dev) - (torch.cumsum(nblk, 0)
                                                - nblk)[seg] + 2
    ctr_blocks = torch.cat([nonces[seg], _be(ctr, 4)], 1)
    j0 = torch.cat([nonces, _be(torch.ones(p, dtype=torch.int64,
                                           device=dev), 4)], 1)
    zero = torch.zeros((1, 16), dtype=torch.uint8, device=dev)
    enc = aes_encrypt_blocks(key, torch.cat([zero, j0, ctr_blocks]))
    h_bits = _to_bits(enc[0])
    ks, _ = _segments(enc[1 + p:].reshape(-1),
                      torch.cumsum(nblk * 16, 0) - nblk * 16, lens)
    return ks, enc[1:1 + p], h_bits


def _scatter(out: torch.Tensor, flat: torch.Tensor, offs: torch.Tensor,
             lens: torch.Tensor) -> None:
    """out[offs[p] : offs[p] + lens[p]] = the p-th segment of flat."""
    dev = out.device
    if not len(flat):
        return
    seg = torch.repeat_interleave(torch.arange(len(lens), device=dev), lens)
    pos = torch.arange(len(flat), device=dev) - (torch.cumsum(lens, 0)
                                                 - lens)[seg]
    out[offs[seg] + pos] = flat


def seal_plain(key: bytes, data: torch.Tensor, desc: torch.Tensor,
               nonces: torch.Tensor, aad: torch.Tensor,
               out_size: int) -> torch.Tensor:
    """Seal each package (see the module docstring): uint8 [out_size]
    with nonce || ciphertext || tag at each out_off; other bytes 0."""
    _check_desc(desc, data, aad, nonces)
    dev = data.device
    p = desc.shape[0]
    out = torch.zeros(out_size, dtype=torch.uint8, device=dev)
    if p == 0:
        return out
    lens = desc[:, 1]
    ks, ej0, h_bits = _keystream(key, nonces, lens)
    pt, _ = _segments(data, desc[:, 0], lens)
    ct = pt ^ ks
    ct_offs = torch.cumsum(lens, 0) - lens
    tags = _ghash(h_bits, aad, desc, ct, ct_offs) ^ ej0
    out_offs = desc[:, 4]
    _scatter(out, nonces.reshape(-1), out_offs,
             torch.full((p,), NONCE, dtype=torch.int64, device=dev))
    _scatter(out, ct, out_offs + NONCE, lens)
    _scatter(out, tags.reshape(-1), out_offs + NONCE + lens,
             torch.full((p,), TAG, dtype=torch.int64, device=dev))
    return out


def open_plain(key: bytes, data: torch.Tensor, desc: torch.Tensor,
               aad: torch.Tensor,
               out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Open each package (see the module docstring): (uint8 [out_size]
    with each package's plaintext at its out_off, zeros where its tag
    failed; bool [P], the tag checks)."""
    _check_desc(desc, data, aad)
    dev = data.device
    p = desc.shape[0]
    out = torch.zeros(out_size, dtype=torch.uint8, device=dev)
    if p == 0:
        return out, torch.zeros(0, dtype=torch.bool, device=dev)
    in_offs, lens = desc[:, 0], desc[:, 1]
    nonces, _ = _segments(data, in_offs,
                          torch.full((p,), NONCE, dtype=torch.int64,
                                     device=dev))
    nonces = nonces.reshape(p, NONCE)
    tags, _ = _segments(data, in_offs + NONCE + lens,
                        torch.full((p,), TAG, dtype=torch.int64, device=dev))
    ks, ej0, h_bits = _keystream(key, nonces, lens)
    ct, _ = _segments(data, in_offs + NONCE, lens)
    want = _ghash(h_bits, aad, desc, data, in_offs + NONCE) ^ ej0
    ok = (want == tags.reshape(p, TAG)).all(dim=1)
    pt = ct ^ ks
    seg = torch.repeat_interleave(torch.arange(p, device=dev), lens)
    pt[~ok[seg]] = 0
    _scatter(out, pt, desc[:, 4], lens)
    return out, ok
