"""GraphBLAS error model.

The reference returns ``GrB_Info`` codes from all 859 API functions and keeps
a per-object error-logger string (reference: Source/GrB_error.c,
Source/Shared/GB_matrix.h:40-41).  In Python the idiomatic equivalent is an
exception hierarchy; we keep the same taxonomy and names so a user of the
reference can map errors 1:1.
"""

from __future__ import annotations


class GraphBLASError(Exception):
    """Base class for all GraphBLAS errors (== any non-SUCCESS GrB_Info)."""

    info = "GrB_PANIC"


# --- API errors (reference: Include/GraphBLAS.h GrB_Info enum) -------------

class UninitializedObject(GraphBLASError):
    info = "GrB_UNINITIALIZED_OBJECT"


class NullPointer(GraphBLASError):
    info = "GrB_NULL_POINTER"


class InvalidValue(GraphBLASError):
    info = "GrB_INVALID_VALUE"


class InvalidIndex(GraphBLASError):
    info = "GrB_INVALID_INDEX"


class DomainMismatch(GraphBLASError):
    info = "GrB_DOMAIN_MISMATCH"


class DimensionMismatch(GraphBLASError):
    info = "GrB_DIMENSION_MISMATCH"


class OutputNotEmpty(GraphBLASError):
    info = "GrB_OUTPUT_NOT_EMPTY"


class NotImplementedYet(GraphBLASError):
    info = "GrB_NOT_IMPLEMENTED"


class EmptyObject(GraphBLASError):
    info = "GrB_EMPTY_OBJECT"


# --- execution errors -------------------------------------------------------

class IndexOutOfBounds(GraphBLASError):
    info = "GrB_INDEX_OUT_OF_BOUNDS"


class OutOfMemory(GraphBLASError):
    info = "GrB_OUT_OF_MEMORY"


class InsufficientSpace(GraphBLASError):
    info = "GrB_INSUFFICIENT_SPACE"


class InvalidObject(GraphBLASError):
    info = "GrB_INVALID_OBJECT"


class NoValue(GraphBLASError, KeyError):
    """Entry not present (GrB_NO_VALUE from extractElement)."""

    info = "GrB_NO_VALUE"
