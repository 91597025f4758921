"""Kernels C and D's wrappers: AES-256-GCM seal and open of a batch of
packages as hand-written CUDA kernels (csrc/aes_gcm.cu). They replace
`cryptography`'s AESGCM, which minio_tpu calls on the host; the plain
PyTorch version of both is ops/aes_gcm.py, and `seal` / `open_` below
take it for CPU tensors.

A batch shares one key; the descriptor int64 [P, 5] gives each package
(in_off, length, aad_off, aad_len, out_off), as ops/aes_gcm.py says. The
kernels write only the packages' bytes: an output byte that no package
covers is left as torch.empty made it. Each call also allocates the
launch's workspace on the current stream: powers of H and the nibble
tables of H^CT, which the setup kernel the C entry point enqueues before
the main one writes.
"""

from __future__ import annotations

import torch

from . import _build, aes_gcm

# Threads of a block and the cluster sizes of the main kernels, as
# csrc/aes_gcm.cu's kThreads and the cluster sizes it is built for (the
# GHASH model of tests/test_torch_aes_gcm.py follows them).
THREADS = 256
CLUSTER_SIZES = (2, 4, 8)

# Kernel launches made by this process (see rs_cuda.LAUNCHES), one a
# wrapper call, and the same by package count.
SEAL_LAUNCHES = _build.LaunchCounter()
OPEN_LAUNCHES = _build.LaunchCounter()
SEAL_LAUNCHES_BY_SHAPE = _build.ShapeLaunchCounter()
OPEN_LAUNCHES_BY_SHAPE = _build.ShapeLaunchCounter()


def _workspace(lib, dev: torch.device) -> torch.Tensor:
    return torch.empty(lib.aes_gcm_workspace_bytes(), dtype=torch.uint8,
                       device=dev)


def cluster_size(packages: int) -> int:
    """Blocks a package takes in a launch of `packages` (the card's
    library decides; builds it on first use)."""
    return _build.library("aes_gcm").aes_gcm_cluster_size(packages)


def _check(key: bytes, tensors: dict, desc: torch.Tensor) -> torch.device:
    if len(key) != 32:
        raise ValueError(f"AES-256 needs a 32-byte key, got {len(key)}")
    dev = desc.device
    if dev.type != "cuda":
        raise ValueError(f"the AES-GCM kernels need CUDA tensors, got {dev}")
    if desc.dtype != torch.int64 or desc.dim() != 2 or desc.shape[1] != 5 \
            or not desc.is_contiguous():
        raise ValueError(f"desc must be contiguous int64 [P, 5], got "
                         f"{desc.dtype} {tuple(desc.shape)}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, desc on {dev}")
        if t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous uint8, got "
                             f"{t.dtype}")
    return dev


def seal_cuda(key: bytes, data: torch.Tensor, desc: torch.Tensor,
              nonces: torch.Tensor, aad: torch.Tensor,
              out_size: int) -> torch.Tensor:
    """Kernel C on the current stream: uint8 [out_size] on the card with
    nonce || ciphertext || tag at each package's out_off."""
    dev = _check(key, {"data": data, "nonces": nonces, "aad": aad}, desc)
    if nonces.shape != (desc.shape[0], aes_gcm.NONCE):
        raise ValueError(f"nonces must be [{desc.shape[0]}, 12], got "
                         f"{tuple(nonces.shape)}")
    out = torch.empty(out_size, dtype=torch.uint8, device=dev)
    if desc.shape[0] == 0:
        return out
    lib = _build.library("aes_gcm")
    ws = _workspace(lib, dev)
    _check(key, {"workspace": ws}, desc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(
        lib.aes_gcm_seal_launch(data.data_ptr(), desc.data_ptr(),
                                nonces.data_ptr(), aad.data_ptr(),
                                out.data_ptr(), desc.shape[0], bytes(key),
                                ws.data_ptr(), stream),
        "aes_gcm_seal_launch",
    )
    SEAL_LAUNCHES.add()
    SEAL_LAUNCHES_BY_SHAPE.add(str(desc.shape[0]))
    return out


def open_cuda(key: bytes, data: torch.Tensor, desc: torch.Tensor,
              aad: torch.Tensor,
              out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D on the current stream: (uint8 [out_size] with each
    package's plaintext at its out_off, zeros where its tag failed;
    uint8 [P], 1 where the tag checked)."""
    dev = _check(key, {"data": data, "aad": aad}, desc)
    out = torch.empty(out_size, dtype=torch.uint8, device=dev)
    ok = torch.empty(desc.shape[0], dtype=torch.uint8, device=dev)
    if desc.shape[0] == 0:
        return out, ok
    lib = _build.library("aes_gcm")
    ws = _workspace(lib, dev)
    _check(key, {"workspace": ws}, desc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(
        lib.aes_gcm_open_launch(data.data_ptr(), desc.data_ptr(),
                                aad.data_ptr(), out.data_ptr(),
                                ok.data_ptr(), desc.shape[0], bytes(key),
                                ws.data_ptr(), stream),
        "aes_gcm_open_launch",
    )
    OPEN_LAUNCHES.add()
    OPEN_LAUNCHES_BY_SHAPE.add(str(desc.shape[0]))
    return out, ok


def seal(key: bytes, data: torch.Tensor, desc: torch.Tensor,
         nonces: torch.Tensor, aad: torch.Tensor,
         out_size: int) -> torch.Tensor:
    """Seal a batch on the tensors' device: kernel C on the card, the
    plain version on the CPU."""
    if desc.device.type == "cpu":
        return aes_gcm.seal_plain(key, data, desc, nonces, aad, out_size)
    return seal_cuda(key, data, desc, nonces, aad, out_size)


def open_(key: bytes, data: torch.Tensor, desc: torch.Tensor,
          aad: torch.Tensor,
          out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Open a batch on the tensors' device: (plaintexts, bool ok [P])."""
    if desc.device.type == "cpu":
        return aes_gcm.open_plain(key, data, desc, aad, out_size)
    out, ok = open_cuda(key, data, desc, aad, out_size)
    return out, ok.bool()
