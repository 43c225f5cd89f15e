"""Enforce-style error checking.

Reference parity: ``PADDLE_ENFORCE*`` macros (paddle/common/enforce.h) and
the typed error taxonomy (paddle/common/errors.h): InvalidArgument,
NotFound, OutOfRange, Unimplemented, PreconditionNotMet, etc.  The macros'
error-stack formatting collapses to plain Python exceptions with the same
category names so user-facing messages keep the reference's shape.
"""
from __future__ import annotations

__all__ = [
    "EnforceError",
    "InvalidArgumentError",
    "NotFoundError",
    "OutOfRangeError",
    "AlreadyExistsError",
    "PermissionDeniedError",
    "PreconditionNotMetError",
    "UnimplementedError",
    "UnavailableError",
    "ExecutionTimeoutError",
    "CorruptCheckpointError",
    "enforce",
    "enforce_eq",
    "enforce_gt",
    "enforce_not_none",
]


class EnforceError(RuntimeError):
    category = "Fatal"

    def __init__(self, msg: str):
        super().__init__(f"({self.category}) {msg}")


class InvalidArgumentError(EnforceError, ValueError):
    category = "InvalidArgument"


class NotFoundError(EnforceError, KeyError):
    category = "NotFound"


class OutOfRangeError(EnforceError, IndexError):
    category = "OutOfRange"


class AlreadyExistsError(EnforceError):
    category = "AlreadyExists"


class PermissionDeniedError(EnforceError):
    category = "PermissionDenied"


class PreconditionNotMetError(EnforceError):
    category = "PreconditionNotMet"


class UnimplementedError(EnforceError, NotImplementedError):
    category = "Unimplemented"


class UnavailableError(EnforceError):
    category = "Unavailable"


class ExecutionTimeoutError(EnforceError):
    category = "ExecutionTimeout"


class CorruptCheckpointError(EnforceError):
    """A checkpoint directory failed integrity checks: missing/torn
    manifest, uncommitted staging state, missing chunk files, or a
    per-chunk sha256 mismatch.  Callers (CheckpointManager.restore,
    auto_resume) catch this to fall back to the previous valid
    checkpoint."""
    category = "CorruptCheckpoint"


def enforce(cond, msg: str, error_cls=InvalidArgumentError):
    if not cond:
        raise error_cls(msg)


def enforce_eq(a, b, msg: str = "", error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(f"expected {a!r} == {b!r}. {msg}")


def enforce_gt(a, b, msg: str = "", error_cls=InvalidArgumentError):
    if not a > b:
        raise error_cls(f"expected {a!r} > {b!r}. {msg}")


def enforce_not_none(x, name: str = "value", error_cls=InvalidArgumentError):
    if x is None:
        raise error_cls(f"{name} must not be None")
    return x
