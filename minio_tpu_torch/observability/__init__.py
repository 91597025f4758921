"""Observability of the port, its copy of minio_tpu/observability: the
metrics registry (`metrics`) and its descriptor catalog and scrape-time
collector (`metrics_v2`), request spans (`spans`) and the byte-flow
ledger (`ioflow`). The trace hub, pub/sub, audit log, profiler and
bandwidth monitor are not ported yet."""

from .metrics import Metrics


def carry(fn):
    """Bind `fn` to the calling thread's request-scoped observability
    context, the span trace and the byte-flow op tag, for handing to
    another thread (a pool submit, a Thread target). Contextvars do not
    cross threads; every fan-out site uses this one helper, so no site
    can carry one half and lose the other."""
    from . import ioflow, spans

    return ioflow.carry(spans.bound(spans.capture(), fn))


__all__ = ["Metrics", "carry"]
