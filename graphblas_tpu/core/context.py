"""Execution contexts — the GxB_Context analog (reference:
Source/GB_Context.c: per-user-thread object holding nthreads_max/chunk,
engaged via OpenMP threadprivate TLS).

Here the resources a context governs are different: which device ops
dispatch to and the work-chunking granularity.  Same shape: thread-local,
engage/disengage, nestable via `with`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

from . import config as CFG

_tls = threading.local()


@dataclasses.dataclass
class Context:
    """Per-thread execution context (GxB_Context_new/engage/disengage)."""

    device: Any = None          # jax device for dispatch (None = default)
    chunk: int = 65536          # work granularity (GxB_CHUNK analog)
    name: str = ""

    def engage(self) -> "Context":
        _tls.ctx = self
        return self

    def disengage(self) -> None:
        if getattr(_tls, "ctx", None) is self:
            _tls.ctx = None

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        return self.engage()

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def current() -> Context:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = Context(chunk=CFG.GLOBAL.chunk, name="world")
        _tls.ctx = ctx
    return ctx


def device_put_ctx(x):
    """Place an array per the engaged context's device."""
    import jax
    ctx = current()
    return jax.device_put(x, ctx.device) if ctx.device is not None else x
