"""Global runtime state + burble tracing.

Reference: Source/GB_Global.c (global mode, hyper/bitmap switches, burble,
malloc tracking) and Source/GB_init.c.  There is no malloc machinery to
manage — XLA owns device memory — so the global state reduces to tunables,
format-switch thresholds, the burble diagnostic stream, and mode.

``burble`` replicates the reference's GBURBLE diagnostics (Source/
GB_AxB_saxpy.c:147-165): every op logs its chosen method/format so users can
see why a kernel was picked.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable


@dataclasses.dataclass
class _Global:
    initialized: bool = False
    # blocking (ops finalize pending work eagerly) vs nonblocking.
    blocking: bool = False
    burble: bool = False
    printf: Callable[[str], None] = lambda s: print(s, file=sys.stderr)
    # format auto-switch thresholds (reference: GB_Global.c:124-141;
    # hyper_switch default 1/16, bitmap_switch dimension-dependent).
    bitmap_switch: float = 0.10   # nvals/(nrows*ncols) above which -> bitmap
    hyper_switch: float = 1.0 / 16.0  # nvec_nonempty/nvec below which -> hyper
    # default orientation for new matrices ('row' == CSR, like the reference
    # default GrB_init is_csc=false; Source/GB_init.c).
    format_default: str = "row"
    # chunk: work per "task" (GxB_CHUNK analog).
    chunk: int = 65536
    # dev timing array (reference: GB_Global.timing[40]).
    timing: dict = dataclasses.field(default_factory=dict)


GLOBAL = _Global()


# Default cache location on accelerator backends: a fixed directory at the
# checkout root (the path is part of the cache key, so it must not move).
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def init(mode: str = "nonblocking", compilation_cache_dir: str | None = None
         ) -> None:
    """GrB_init (reference: Source/GB_init.c:60-197).

    Also enables XLA's persistent compilation cache — the analog of the
    reference's PreJIT/JIT kernel cache in ~/.SuiteSparse/GrBx.y.z
    (Source/GB_jitifyer.c): compiled kernels survive process restarts.
    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and nothing
    is changed here.  Otherwise ``compilation_cache_dir`` is used, or, on an
    accelerator backend, ``.jax_cache/`` at the checkout root;
    GB_NO_JIT_CACHE opts out."""
    GLOBAL.initialized = True
    GLOBAL.blocking = (mode == "blocking")
    if os.environ.get("GB_BURBLE"):
        GLOBAL.burble = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    backend = jax.default_backend()
    if compilation_cache_dir is None:
        # The CPU backend is excluded unless a dir is passed explicitly:
        # XLA:CPU persists AOT machine code and its loader itself warns
        # reloads "could lead to execution errors such as SIGILL" on
        # feature mismatch — observed as intermittent segfaults in long
        # test runs; CPU compiles are cheap anyway.
        if os.environ.get("GB_NO_JIT_CACHE") or backend == "cpu":
            return
        compilation_cache_dir = _DEFAULT_CACHE_DIR
    if backend == "cpu":
        # XLA:CPU AOT blobs carry machine-feature lists, and loading one
        # written on a host with other CPU flags crashes: partition an
        # explicit CPU cache by a host fingerprint.
        import hashlib
        sub = "cpu"
        try:
            with open("/proc/cpuinfo") as f:
                flags = next((ln for ln in f if ln.startswith("flags")), "")
            sub += "-" + hashlib.sha1(flags.encode()).hexdigest()[:8]
        except OSError:  # pragma: no cover - non-Linux host
            pass
        compilation_cache_dir = os.path.join(str(compilation_cache_dir), sub)
    os.makedirs(compilation_cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(compilation_cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def finalize() -> None:
    """GrB_finalize."""
    GLOBAL.initialized = False


def set_option(name: str, value) -> None:
    """GrB_set(GrB_GLOBAL, ...) analog."""
    if not hasattr(GLOBAL, name):
        raise KeyError(f"unknown global option {name!r}")
    setattr(GLOBAL, name, value)


def get_option(name: str):
    """GrB_get(GrB_GLOBAL, ...) analog."""
    return getattr(GLOBAL, name)


def burble(msg: str, *args) -> None:
    if GLOBAL.burble:
        GLOBAL.printf("[GB] " + (msg % args if args else msg))


class timed:
    """Context manager feeding GLOBAL.timing — dev counterpart of the
    reference's GB_Global.timing[40]."""

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        GLOBAL.timing[self.key] = GLOBAL.timing.get(self.key, 0.0) + (
            time.perf_counter() - self.t0)
        return False
