"""Converter SPI: TIFF -> JPEG 2000 on the card, and the read path back
to pixels."""
from .base import Conversion, Converter, ConverterError, output_path
from .cuda import CudaConverter
from .reader import CudaReader, derivative_path

__all__ = ["Conversion", "Converter", "ConverterError", "CudaConverter",
           "CudaReader", "derivative_path", "output_path"]
