"""Kernels E and F's wrappers: snappy block compression and framed-chunk
decompression with CRC32C as hand-written CUDA kernels (csrc/s2.cu).
They replace minio_tpu's native C codec (minio_tpu/native/snappy.c
through minio_tpu/ops/s2.py compress_block, decompress_block and
crc32c), which the port may not load; the plain versions are
ops/s2.py's compress_plain and decompress_plain, and `compress` /
`decompress` below take them for CPU tensors. A CUDA tensor launches the
kernel or raises: nothing falls back to the plain codec on the card.

E: desc int64 [N, 3] gives each chunk's (in_off, length, out_off), a
chunk at most 64 KiB and its output slot max_compressed(length) bytes
long. F: desc int64 [N, 5] gives each frame's (type, body offset, body
length, out_off, out_len), out_len at most 64 KiB.
"""

from __future__ import annotations

import torch

from . import _build, s2

# Kernel launches made by this process (see rs_cuda.LAUNCHES), one a
# wrapper call, and the same by chunk count.
COMPRESS_LAUNCHES = _build.LaunchCounter()
DECOMPRESS_LAUNCHES = _build.LaunchCounter()
COMPRESS_LAUNCHES_BY_SHAPE = _build.ShapeLaunchCounter()
DECOMPRESS_LAUNCHES_BY_SHAPE = _build.ShapeLaunchCounter()


def _check(data: torch.Tensor, desc: torch.Tensor, cols: int) -> None:
    if desc.device.type != "cuda" or data.device != desc.device:
        raise ValueError(f"the S2 kernels need CUDA tensors on one device, "
                         f"got {data.device} and {desc.device}")
    if desc.dtype != torch.int64 or desc.dim() != 2 \
            or desc.shape[1] != cols or not desc.is_contiguous():
        raise ValueError(f"desc must be contiguous int64 [N, {cols}], got "
                         f"{desc.dtype} {tuple(desc.shape)}")
    if data.dtype != torch.uint8 or data.dim() != 1 \
            or not data.is_contiguous():
        raise ValueError(f"data must be contiguous uint8 [T], got "
                         f"{data.dtype} {tuple(data.shape)}")


def compress_cuda(data: torch.Tensor, desc: torch.Tensor, out_size: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel E on the current stream: (uint8 [out_size] with each
    chunk's snappy block at its out_off, int64 [N] masked CRC32Cs,
    int64 [N] block lengths). Bytes past a block in its slot are left as
    torch.empty made them."""
    _check(data, desc, 3)
    dev = desc.device
    n = desc.shape[0]
    out = torch.empty(out_size, dtype=torch.uint8, device=dev)
    crcs = torch.empty(n, dtype=torch.int64, device=dev)
    lens = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out, crcs, lens
    lib = _build.library("s2")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(
        lib.s2_compress_launch(data.data_ptr(), desc.data_ptr(),
                               out.data_ptr(), crcs.data_ptr(),
                               lens.data_ptr(), n, stream),
        "s2_compress_launch")
    COMPRESS_LAUNCHES.add()
    COMPRESS_LAUNCHES_BY_SHAPE.add(str(n))
    return out, crcs, lens


def decompress_cuda(data: torch.Tensor, desc: torch.Tensor, out_size: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel F on the current stream: (uint8 [out_size] with each
    frame's raw bytes at its out_off, uint8 [N] status: 0 ok, 1 CRC
    mismatch, 2 malformed). A frame writes only its own slot."""
    _check(data, desc, 5)
    dev = desc.device
    n = desc.shape[0]
    out = torch.empty(out_size, dtype=torch.uint8, device=dev)
    status = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return out, status
    lib = _build.library("s2")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(
        lib.s2_decompress_launch(data.data_ptr(), desc.data_ptr(),
                                 out.data_ptr(), status.data_ptr(), n,
                                 stream),
        "s2_decompress_launch")
    DECOMPRESS_LAUNCHES.add()
    DECOMPRESS_LAUNCHES_BY_SHAPE.add(str(n))
    return out, status


def compress(data: torch.Tensor, desc: torch.Tensor, out_size: int):
    """Kernel E's function on the tensors' device: the kernel on the
    card, the plain version on the CPU."""
    if desc.device.type == "cpu":
        return s2.compress_plain(data, desc, out_size)
    return compress_cuda(data, desc, out_size)


def decompress(data: torch.Tensor, desc: torch.Tensor, out_size: int):
    """Kernel F's function on the tensors' device."""
    if desc.device.type == "cpu":
        return s2.decompress_plain(data, desc, out_size)
    return decompress_cuda(data, desc, out_size)
