"""Converter SPI: TIFF -> JPEG 2000 on the card, the read path back to
pixels, and the CLI converters wrapping ``kdu_compress`` /
``opj_compress`` when installed (the JAX package's converter layer, with
:class:`CudaConverter` / :class:`CudaReader` in the place of
``TpuConverter`` / ``TpuReader``)."""
from .base import Conversion, Converter, ConverterError, output_path
from .cli import CliConverter, KakaduConverter, OpenJPEGConverter
from .cuda import CudaConverter
from .factory import available_converters, get_converter
from .reader import CudaReader, derivative_path

__all__ = [
    "Conversion", "Converter", "ConverterError", "output_path",
    "CliConverter", "KakaduConverter", "OpenJPEGConverter",
    "CudaConverter", "CudaReader", "derivative_path", "get_converter",
    "available_converters",
]
