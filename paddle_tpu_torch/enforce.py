"""Typed errors the port raises (counterpart: ``paddle_tpu/enforce.py``
``enforce`` and its error taxonomy, trimmed to what this package uses)."""

from __future__ import annotations

from typing import Any, Optional

__all__ = ["EnforceNotMet", "InvalidArgumentError", "UnimplementedError",
           "PreconditionNotMetError", "enforce", "enforce_in"]


class EnforceNotMet(RuntimeError):
    """Base of the typed errors; carries an optional op and a context
    dict rendered after the message."""

    error_type = "EnforceNotMet"

    def __init__(self, message: str, op: Optional[str] = None, **context):
        self.op = op
        self.context = context
        super().__init__(message)

    def __str__(self):
        parts = [f"[{self.error_type}] {self.args[0]}"]
        if self.op:
            parts.append(f"  [operator: {self.op}]")
        for k, v in self.context.items():
            parts.append(f"  [{k}: {_fmt(v)}]")
        return "\n".join(parts)


class InvalidArgumentError(EnforceNotMet, ValueError):
    error_type = "InvalidArgument"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    error_type = "Unimplemented"


class PreconditionNotMetError(EnforceNotMet, ValueError):
    error_type = "PreconditionNotMet"


def _fmt(v: Any) -> str:
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is not None and dtype is not None:
        return f"Tensor(shape={tuple(shape)}, dtype={dtype})"
    return repr(v)


def enforce(cond: Any, message: str, *, error=InvalidArgumentError,
            op: Optional[str] = None, **context) -> None:
    """Raise ``error`` with op/shape context unless ``cond``."""
    if not cond:
        raise error(message, op=op, **context)


def enforce_in(value, options, message: str = "", **kw) -> None:
    """Raise unless ``value`` is one of ``options``."""
    shown = sorted(options, key=repr)  # repr-keyed: mixed types sort too
    enforce(value in options,
            message or f"{value!r} not in allowed set {shown!r}",
            value=value, options=shown, **kw)
