"""Kernel A's wrapper: the GF(2^8) apply as a hand-written CUDA kernel
(csrc/gf_apply.cu), the counterpart of minio_tpu/ops/rs_pallas.py.

`apply_gf_matrix_cuda` takes the interleaved bit-matrix itself; the
kernel builds its per-row constants in shared memory, so there is no
plane-major column permutation as the Pallas kernel needs. Its only
limit is shared memory: a 33,280-byte ring of shard rows plus 32 bytes a
shard and output row of a pass (up to eight rows), 98,816 bytes at
K = 256 and 163,328 at K = 508, so it takes K <= 778 input rows (the
launch checks it), any R, any batch and any S. The sub-shard view of
the msr-pm codec gives it K = k*alpha and R = r*alpha: up to K = 508
(254+2) and R = 256 (128+128) among the geometries the registry admits.
"""

from __future__ import annotations

import torch

from . import _build

# Kernel launches made by this process: the smoke run reads it to show
# that the main path went through the kernel.
LAUNCHES = _build.LaunchCounter()
# The same launches by shape, "{R}x{K}" (rows out x rows in).
LAUNCHES_BY_SHAPE = _build.ShapeLaunchCounter()

_MAX_SMEM = 232_448  # shared memory one block may use on Hopper (227 KB)


def apply_gf_matrix_cuda(bitmat: torch.Tensor,
                         shards: torch.Tensor) -> torch.Tensor:
    """bitmat int8 [8R, 8K] with entries 0/1, shards uint8 [B, K, S], both
    contiguous on one CUDA device -> uint8 [B, R, S] on that device,
    computed by kernel A on the current stream."""
    if bitmat.device.type != "cuda" or shards.device != bitmat.device:
        raise ValueError(
            f"apply_gf_matrix_cuda needs both tensors on one CUDA device, "
            f"got {bitmat.device} and {shards.device}"
        )
    if bitmat.dtype != torch.int8 or shards.dtype != torch.uint8:
        raise TypeError(f"want int8 bitmat and uint8 shards, got "
                        f"{bitmat.dtype} and {shards.dtype}")
    if not (bitmat.is_contiguous() and shards.is_contiguous()):
        raise ValueError("apply_gf_matrix_cuda needs contiguous tensors")
    if bitmat.dim() != 2 or shards.dim() != 3:
        raise ValueError(f"want bitmat [8R, 8K] and shards [B, K, S], got "
                         f"{tuple(bitmat.shape)} and {tuple(shards.shape)}")
    r8, k8 = bitmat.shape
    b, k, s = shards.shape
    if r8 % 8 or k8 != 8 * k or r8 == 0 or k == 0:
        raise ValueError(f"bitmat {tuple(bitmat.shape)} does not fit "
                         f"shards {tuple(shards.shape)}")
    r = r8 // 8
    lib = _build.library("gf_apply")
    if lib.gf_apply_smem_bytes(k, r) > _MAX_SMEM:  # K > 778
        raise ValueError(
            f"geometry {k}->{r}: the kernel's ring and constants exceed "
            f"{_MAX_SMEM} bytes of shared memory"
        )
    out = torch.empty((b, r, s), dtype=torch.uint8, device=shards.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(shards.device).cuda_stream
    _build.check(
        lib.gf_apply_launch(bitmat.data_ptr(), shards.data_ptr(),
                            out.data_ptr(), b, k, r, s, stream),
        "gf_apply_launch",
    )
    LAUNCHES.add()
    LAUNCHES_BY_SHAPE.add(f"{r}x{k}")
    return out
