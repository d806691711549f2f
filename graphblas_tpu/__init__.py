"""graphblas_tpu — a GraphBLAS framework in JAX.

A from-scratch JAX/XLA implementation of the GraphBLAS C API v2.1
capability set (reference: SuiteSparse:GraphBLAS v9.1.0): sparse linear
algebra over arbitrary semirings, with masks, accumulators, non-blocking
mode, 4 storage formats x 2 orientations, and a net-new distributed layer
over jax.sharding meshes.

Architecture: see ARCHITECTURE.md.  The reference's FactoryKernels (928k
generated LoC) + runtime C JIT collapse into jax.jit tracing of polymorphic
operator callables; its OpenMP task slicing becomes vectorized array
programs compiled by XLA; its missing multi-device story becomes shard_map
over a jax.sharding mesh.
"""

# GraphBLAS requires 64-bit types (int64 indices/values, fp64).
import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .core import config as _cfg
from .core import context as context
from .core import descriptor, errors, monoid, semiring, types
from .core import ops as operators
from .core.context import Context
from .core.config import burble, finalize, get_option, init, set_option
from .core.descriptor import Descriptor
from .core.matrix import (BITMAP, COL, FULL, HYPER, ROW, SPARSE,
                          Matrix, Scalar, Vector)
from .core.monoid import Monoid, monoid as make_monoid
from .core.ops import (BinaryOp, IndexUnaryOp, UnaryOp, binary_op,
                       index_unary_op, unary_op)
from .core.semiring import Semiring, semiring as make_semiring
from .core import names as names
from .core.names import lookup as lookup_name

__version__ = "0.1.0"


def __getattr__(name):
    # operation layer is imported lazily to keep import light
    import importlib
    _api = importlib.import_module(".api", __name__)
    globals()["api"] = _api
    if hasattr(_api, name):
        return getattr(_api, name)
    raise AttributeError(name)
