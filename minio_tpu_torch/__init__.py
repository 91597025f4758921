"""minio_tpu_torch: minio_tpu on PyTorch and CUDA: the erasure data plane,
the object layer and drive storage above it, and the S3 server
(``python -m minio_tpu_torch server /data{1...16}``).

The GF(2^8) Reed-Solomon apply and the HighwayHash-256 bitrot digests run
as hand-written CUDA kernels (``csrc/``) on an NVIDIA Hopper card. Every
public entry point takes ``device=`` and defaults to ``"cuda"``; on a host
without a card it raises rather than running on the CPU. Passing
``device="cpu"`` runs the plain PyTorch versions of the kernels, which is
how the tests hold the port against the JAX package.

Importing this package has no side effects: nothing is built or loaded
until a kernel is first launched.
"""
