"""The port's AESGCM: AES-256-GCM on the server's device, in place of
`cryptography`'s AESGCM that minio_tpu calls on the host.

`AESGCM(key, device).encrypt(nonce, data, aad)` and `.decrypt(...)` take
one message as `cryptography` does (ciphertext || tag; InvalidTag on a
failed check); `seal_packages` and `open_packages` take a batch of
packages under the key in one launch. On the card every call is kernel C
or D (ops/aes_gcm_cuda.py): the host packs the inputs and one descriptor
into one pinned buffer, copies it over on the current stream, launches,
copies the output back into pinned memory and waits for an event
recorded after that copy before it reads a byte; the batch calls hand that memory back as a
memoryview, with no further copy. Nothing runs AES on the host when the
device is a card. On the CPU the same calls take the plain version
(ops/aes_gcm.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import aes_gcm, aes_gcm_cuda, host_feed
from ..utils.device import resolve_device

NONCE, TAG, OVERHEAD = aes_gcm.NONCE, aes_gcm.TAG, aes_gcm.OVERHEAD


class InvalidTag(Exception):
    """A package's tag did not check: wrong key, nonce, AAD or bytes."""


class AESGCM:
    """AES-256-GCM under one 32-byte key on `device` (the card unless
    the caller asks for the CPU; raises where there is no card)."""

    def __init__(self, key: bytes, device="cuda"):
        key = bytes(key)
        if len(key) != 32:
            raise ValueError(f"AES-256-GCM needs a 32-byte key, got "
                             f"{len(key)}")
        self._key = key
        self.device = resolve_device(device)

    # --- host <-> device -------------------------------------------------

    def _stage(self, desc: np.ndarray, parts: list) -> list[torch.Tensor]:
        """The descriptor and the byte strings `parts` as tensors on the
        device: one pinned buffer and one copy on the card."""
        sizes = [len(p) for p in parts]
        dbytes = desc.size * 8
        host = torch.empty(dbytes + sum(sizes), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        hv = host.numpy()
        hv[:dbytes] = desc.reshape(-1).view(np.uint8)
        pos = dbytes
        for p in parts:
            hv[pos:pos + len(p)] = np.frombuffer(p, dtype=np.uint8)
            pos += len(p)
        if self.device.type == "cuda":
            host_feed.count_h2d(True, host.numel())
            dev = host.to(self.device, non_blocking=True)
        else:
            dev = host
        out = [dev[:dbytes].view(torch.int64).reshape(desc.shape)]
        pos = dbytes
        for n in sizes:
            out.append(dev[pos:pos + n])
            pos += n
        return out

    def _fetch(self, *tensors: torch.Tensor) -> list[np.ndarray]:
        """The tensors on the host: one event recorded after their copies
        and waited on, so the wait ends with this batch's copy, not with
        work queued on the stream after it."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        copied.synchronize()
        return [h.numpy() for h in hosts]

    # --- batches ---------------------------------------------------------

    def seal_packages(self, plaintext, sizes, nonces, aads) -> memoryview:
        """Seal the packages of `plaintext` (any bytes-like object), cut
        back to back into `sizes`, with one nonce (12 B) and one AAD
        each: the wire layout nonce || ciphertext || tag of each, back to
        back."""
        sizes = np.asarray(sizes, dtype=np.int64).reshape(-1)
        plaintext = memoryview(plaintext).cast("B")
        if int(sizes.sum()) != len(plaintext):
            raise ValueError(f"package sizes sum to {int(sizes.sum())}, "
                             f"the plaintext is {len(plaintext)} B")
        if len(nonces) != len(sizes) or len(aads) != len(sizes):
            raise ValueError("one nonce and one AAD a package")
        if any(len(n) != NONCE for n in nonces):
            raise ValueError("nonces are 12 bytes")
        p = len(sizes)
        desc = aes_gcm.seal_desc(sizes, [len(a) for a in aads])
        d_desc, d_data, d_nonce, d_aad = self._stage(
            desc, [plaintext, b"".join(nonces), b"".join(aads)])
        out = aes_gcm_cuda.seal(self._key, d_data, d_desc,
                                d_nonce.reshape(p, NONCE), d_aad,
                                len(plaintext) + OVERHEAD * p)
        return memoryview(self._fetch(out)[0])

    def open_packages(self, wire, sizes,
                      aads) -> tuple[memoryview, list[bool]]:
        """Open the packages of `wire`, nonce || ciphertext || tag back to
        back, `sizes` their ciphertext lengths: (the plaintexts back to
        back, each package's tag check). A package whose tag fails reads
        as zeros."""
        sizes = np.asarray(sizes, dtype=np.int64).reshape(-1)
        wire = memoryview(wire).cast("B")
        p = len(sizes)
        if int(sizes.sum()) + OVERHEAD * p != len(wire):
            raise ValueError(f"{p} packages of {int(sizes.sum())} B do not "
                             f"fill {len(wire)} B")
        if len(aads) != p:
            raise ValueError("one AAD a package")
        desc = aes_gcm.open_desc(aes_gcm.seal_desc(
            sizes, [len(a) for a in aads]))
        d_desc, d_data, d_aad = self._stage(desc, [wire, b"".join(aads)])
        out, ok = aes_gcm_cuda.open_(self._key, d_data, d_desc, d_aad,
                                     int(sizes.sum()))
        plain, flags = self._fetch(out, ok)
        return memoryview(plain), [bool(f) for f in flags]

    # --- one message, as cryptography's AESGCM ---------------------------

    def encrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes | None) -> bytes:
        """ciphertext || tag of one message."""
        wire = self.seal_packages(data, [len(data)], [bytes(nonce)],
                                  [bytes(associated_data or b"")])
        return bytes(wire[NONCE:])

    def decrypt(self, nonce: bytes, data: bytes,
                associated_data: bytes | None) -> bytes:
        """The plaintext of ciphertext || tag; InvalidTag if it fails."""
        if len(data) < TAG:
            raise InvalidTag("message shorter than its tag")
        plain, ok = self.open_packages(bytes(nonce) + bytes(data),
                                       [len(data) - TAG],
                                       [bytes(associated_data or b"")])
        if not ok[0]:
            raise InvalidTag("tag mismatch")
        return bytes(plain)
