"""Converter selection: the JAX package's converters/factory.py with the
CUDA encoder in the place of the TPU one (reference:
converters/ConverterFactory.java:37-70 probes for Kakadu and falls back
to OpenJPEG; here the in-process encoder is the default and the CLI
tools are opt-in).

Selection order:
1. ``name``, else the ``BUCKETEER_CONVERTER`` env (``cuda`` | ``kakadu``
   | ``openjpeg``);
2. the in-process CUDA converter, also when the named CLI tool is not
   installed (a choice of encoder, not a move off the card: the CUDA
   converter runs on ``device``).
"""
from __future__ import annotations

import os

from .base import Converter
from .cli import KakaduConverter, OpenJPEGConverter
from .cuda import CudaConverter

_BY_NAME = {
    "cuda": CudaConverter,
    "kakadu": KakaduConverter,
    "openjpeg": OpenJPEGConverter,
}

_instances: dict[str, Converter] = {}


def available_converters() -> dict[str, bool]:
    return {
        "cuda": True,
        "kakadu": KakaduConverter.is_available(),
        "openjpeg": OpenJPEGConverter.is_available(),
    }


def get_converter(name: str | None = None,
                  device="cuda") -> Converter:
    """Resolve (and, for ``name=None``, cache per device) the process's
    converter. The CUDA converter encodes on ``device``."""
    key = str(device)
    if name is None and key in _instances:
        return _instances[key]
    choice = (name or os.environ.get("BUCKETEER_CONVERTER")
              or "cuda").lower()
    cls = _BY_NAME.get(choice)
    if cls is None:
        raise ValueError(f"unknown converter: {choice}")
    if cls is not CudaConverter and not cls.is_available():
        cls = CudaConverter
    if cls is CudaConverter:
        # The device's scheduler, which every convert goes through, is
        # built here: "cuda" without a CUDA device raises now, not at
        # the first request.
        from ..engine.scheduler import get_scheduler
        get_scheduler(device)
        converter = cls(device=device)
    else:
        converter = cls()
    if name is None:
        _instances[key] = converter
    return converter
