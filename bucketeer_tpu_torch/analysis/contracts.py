"""Runtime shape/dtype contracts for codec entry points.

``@contract(shapes=..., dtypes=...)`` documents and enforces the array
interface of a function. Checks run under tests (or when
``BUCKETEER_CONTRACTS=1``); in production the decorator returns the
function *unchanged* at decoration time, so the hot path pays nothing —
not even an extra frame. The switch changes no result, only whether
arguments are checked.

Shape specs
    ``shapes={"tiles": ("B", "h", "w")}`` — a tuple per parameter, one
    entry per dimension: an ``int`` must match exactly, a ``str`` is a
    symbolic dimension that must be consistent across every annotated
    argument of the same call, ``None`` matches anything. A ``list`` of
    tuples allows alternative ranks (e.g. grayscale vs RGB).

Dtype specs
    ``dtypes={"src": "integer"}`` — a numpy kind name ("integer",
    "floating", "unsignedinteger", "signedinteger", "bool", "number")
    or an exact dtype name ("uint8"); a tuple allows alternatives.

Violations raise :class:`ContractViolation` (a ``TypeError``) naming the
function, parameter, and the mismatch. Works on numpy arrays and torch
tensors alike: a ``torch.dtype`` is judged by the same kind and exact
names as the numpy dtype of the same name, so a tensor and an array of
one shape and dtype pass and fail alike.
"""
from __future__ import annotations

import functools
import inspect
import os
import sys

import numpy as np
import torch


class ContractViolation(TypeError):
    """An argument broke a @contract shape/dtype declaration."""


def contracts_enabled() -> bool:
    env = os.environ.get("BUCKETEER_CONTRACTS", "").strip().lower()
    if env in ("1", "true", "yes", "on"):
        return True
    if env in ("0", "false", "no", "off"):
        return False
    return "pytest" in sys.modules


def _check_shape(fname, pname, value, spec, symbols) -> None:
    shape = getattr(value, "shape", None)
    if shape is None:
        raise ContractViolation(
            f"{fname}: parameter '{pname}' must be array-like "
            f"(got {type(value).__name__})")
    alternatives = spec if isinstance(spec, list) else [spec]
    errors = []
    for alt in alternatives:
        if len(shape) != len(alt):
            errors.append(f"rank {len(shape)} != {len(alt)}")
            continue
        trial = dict(symbols)
        ok = True
        for dim, want in zip(shape, alt):
            if want is None:
                continue
            if isinstance(want, int):
                if dim != want:
                    ok = False
                    errors.append(f"dim {want} != {dim}")
                    break
            else:                      # symbolic
                bound = trial.setdefault(want, dim)
                if bound != dim:
                    ok = False
                    errors.append(f"{want}={bound} but got {dim}")
                    break
        if ok:
            symbols.update(trial)
            return
    raise ContractViolation(
        f"{fname}: parameter '{pname}' has shape {tuple(shape)}, "
        f"expected {spec} ({'; '.join(errors)})")


_KINDS = {"integer": np.integer, "floating": np.floating,
          "unsignedinteger": np.unsignedinteger,
          "signedinteger": np.signedinteger, "bool": np.bool_,
          "number": np.number}


def _torch_kinds(dtype: torch.dtype) -> set:
    """The numpy kind names a torch dtype belongs to."""
    if dtype == torch.bool:
        return {"bool"}
    if dtype.is_complex:
        return {"number"}
    if dtype.is_floating_point:
        return {"floating", "number"}
    if dtype.is_signed:
        return {"integer", "signedinteger", "number"}
    return {"integer", "unsignedinteger", "number"}


def _same_name(name: str, alt: str) -> bool:
    try:
        return name == np.dtype(alt).name
    except TypeError:               # a name numpy lacks, e.g. "bfloat16"
        return name == alt


def _dtype_matches(dtype, alt: str) -> bool:
    if isinstance(dtype, torch.dtype):
        if alt in _KINDS:
            return alt in _torch_kinds(dtype)
        return _same_name(str(dtype).removeprefix("torch."), alt)
    kind = _KINDS.get(alt)
    if kind is not None:
        return np.issubdtype(np.dtype(dtype), kind)
    return np.dtype(dtype) == np.dtype(alt)


def _check_dtype(fname, pname, value, spec) -> None:
    dtype = getattr(value, "dtype", None)
    if dtype is None:
        raise ContractViolation(
            f"{fname}: parameter '{pname}' must carry a dtype "
            f"(got {type(value).__name__})")
    alternatives = spec if isinstance(spec, (tuple, list)) else [spec]
    for alt in alternatives:
        if _dtype_matches(dtype, alt):
            return
    raise ContractViolation(
        f"{fname}: parameter '{pname}' has dtype {dtype}, "
        f"expected {spec}")


def contract(shapes: dict | None = None, dtypes: dict | None = None):
    """Declare (and under tests, enforce) array shapes/dtypes."""
    def decorate(fn):
        if not contracts_enabled():
            return fn
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            symbols: dict = {}
            for pname, spec in (shapes or {}).items():
                if pname in bound.arguments:
                    _check_shape(fn.__qualname__, pname,
                                 bound.arguments[pname], spec, symbols)
            for pname, spec in (dtypes or {}).items():
                if pname in bound.arguments:
                    _check_dtype(fn.__qualname__, pname,
                                 bound.arguments[pname], spec)
            return fn(*args, **kwargs)

        wrapper.__contract__ = {"shapes": shapes, "dtypes": dtypes}
        return wrapper
    return decorate
