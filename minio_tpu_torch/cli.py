"""Command line of the port: `python -m minio_tpu_torch server
/data{1...16}` (the port's copy of minio_tpu/cli.py, MinIO's `minio
server`)."""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="minio-tpu-torch",
        description="S3-compatible erasure-coded object storage on a CUDA "
                    "card")
    sub = p.add_subparsers(dest="command", required=True)
    srv = sub.add_parser("server", help="start the object storage server")
    srv.add_argument("endpoints", nargs="+",
                     help="drive directories, with {1...N} ellipses; one "
                          "pool an argument")
    srv.add_argument("--address", default="127.0.0.1",
                     help="HOST, or HOST:PORT as MinIO takes it (':9000' "
                          "is every interface)")
    srv.add_argument("--port", type=int, default=9000)
    srv.add_argument("--set-drive-count", type=int, default=None,
                     help="drives per erasure set (default: by GCD)")
    srv.add_argument("--device", default="cuda",
                     help="'cuda' (the default) or 'cpu'")
    srv.add_argument("--quiet", action="store_true")
    return p


def parse_address(address: str, port: int) -> tuple[str, int]:
    if ":" in address:
        host, _, p = address.rpartition(":")
        return host or "0.0.0.0", int(p)
    return address, port


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from .server import Server

    host, port = parse_address(args.address, args.port)
    server = Server(args.endpoints, address=host, port=port,
                    set_drive_count=args.set_drive_count,
                    device=args.device).start()
    if not args.quiet:
        print(f"S3 endpoint: http://{server.endpoint}", flush=True)
        print(f"RootUser: {server.root_user}", flush=True)
    try:
        server.wait()
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
