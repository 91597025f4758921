"""Observability of the port: the op tag of minio_tpu's byte-flow ledger
(`ioflow`). The ledger itself, spans, metrics and trace are not ported
yet."""
