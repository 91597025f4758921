"""GF(2^8) Reed-Solomon apply, the counterpart of minio_tpu/ops/rs.py.

`apply_gf_matrix(bitmat, shards)` has the JAX function's contract: an int8
[8R, 8K] bit-matrix in the interleaved order of `gf.bit_matrix` and uint8
[..., K, S] shards with any leading batch dimensions give uint8
[..., R, S]. Tensors on a CUDA device go to kernel A; tensors on the CPU
go to `_apply_bits_plain`, the plain PyTorch version of the same math.
"""

from __future__ import annotations

import torch

from . import rs_cuda


def _apply_bits_plain(bitmat: torch.Tensor,
                      shards: torch.Tensor) -> torch.Tensor:
    """Unpack to bits -> float32 matmul -> & 1 -> repack.

    The 0/1 sums are at most 8K, exact in float32 while 8K < 2^24, so for
    every K (TF32 must be off, which the smoke run sets on the card);
    torch has no int32 matmul on CUDA and its int8 matmul returns
    int8."""
    r8, k8 = bitmat.shape
    lead = shards.shape[:-2]
    s = shards.shape[-1]
    shifts = torch.arange(8, dtype=torch.uint8, device=shards.device)
    bits = (shards[..., :, None, :] >> shifts[:, None]) & 1  # [..., K, 8, S]
    bits = bits.reshape(*lead, k8, s).to(torch.float32)
    acc = torch.matmul(bitmat.to(torch.float32), bits)  # [..., 8R, S]
    obits = (acc.to(torch.int32) & 1).reshape(*lead, r8 // 8, 8, s)
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=shards.device))[:, None]
    return (obits * weights).sum(dim=-2).to(torch.uint8)


def apply_gf_matrix(bitmat: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """bitmat int8 [8R, 8K] (interleaved, entries 0/1), shards uint8
    [..., K, S] on the same device -> uint8 [..., R, S]."""
    if bitmat.device != shards.device:
        raise ValueError(f"bitmat on {bitmat.device}, shards on {shards.device}")
    if bitmat.dim() != 2 or shards.dim() < 2 \
            or bitmat.shape[1] != 8 * shards.shape[-2]:
        raise ValueError(f"bitmat {tuple(bitmat.shape)} does not fit "
                         f"shards {tuple(shards.shape)}")
    if shards.device.type == "cpu":
        return _apply_bits_plain(bitmat, shards)
    lead = shards.shape[:-2]
    k, s = shards.shape[-2:]
    flat = shards.reshape(-1, k, s).contiguous()
    out = rs_cuda.apply_gf_matrix_cuda(bitmat.contiguous(), flat)
    return out.reshape(*lead, out.shape[1], s)
