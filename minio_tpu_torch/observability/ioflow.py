"""The op tag of the byte-flow ledger, the port's copy of the tag half of
minio_tpu/observability/ioflow.py.

A contextvar holds a small mutable holder naming the op class of the
work in progress ("heal", "scan", "get", ...). The heal choke point
(`ErasureObjects.heal_object`), the scanner's cycle and the S3 dispatch
(the request's op class) set it; the heal pacer reads it (`current_op`)
to keep background disk latencies out of its foreground pressure. Nested
tags shadow, and the outer tag comes back on exit. The holder is shared,
so `retag` reclassifies the rest of the work in place. Contextvars do
not cross threads: `carry` binds a pool task or thread target to the tag
of the work that hands it over.

The ledger (`account`, `report`, the hot-bucket sketch) is not ported
yet, so the tag carries the op class alone.
"""

from __future__ import annotations

import contextvars


class _OpTag:
    """The op holder shared by every thread serving one piece of work."""

    __slots__ = ("op",)

    def __init__(self, op: str):
        self.op = op


_op_var: contextvars.ContextVar = contextvars.ContextVar(
    "mtpu_ioflow_op", default=None)


def current_op() -> str:
    t = _op_var.get()
    return t.op if t is not None else "untagged"


def retag(op: str) -> None:
    """Reclassify the current tag in place; a no-op outside a tag."""
    t = _op_var.get()
    if t is not None:
        t.op = op


class tag:
    """Set the op class for the duration of the block."""

    __slots__ = ("_op", "_tok")

    def __init__(self, op: str):
        self._op = op

    def __enter__(self) -> _OpTag:
        holder = _OpTag(self._op)
        self._tok = _op_var.set(holder)
        return holder

    def __exit__(self, *exc):
        _op_var.reset(self._tok)
        return False


def capture():
    """The current tag holder, for handing to another thread; None when
    untagged."""
    return _op_var.get()


class activate:
    """Install a captured holder in this thread for the block; a no-op
    for None. The holder is shared, not copied."""

    __slots__ = ("_holder", "_tok")

    def __init__(self, holder):
        self._holder = holder

    def __enter__(self):
        self._tok = (_op_var.set(self._holder)
                     if self._holder is not None else None)
        return self

    def __exit__(self, *exc):
        if self._tok is not None:
            _op_var.reset(self._tok)
        return False


def carry(fn):
    """`fn` bound to the calling thread's tag, for a pool submit or a
    thread target; `fn` itself when untagged."""
    holder = _op_var.get()
    if holder is None:
        return fn

    def bound(*args, **kwargs):
        with activate(holder):
            return fn(*args, **kwargs)

    return bound
