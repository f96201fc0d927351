"""Converter SPI: TIFF -> JPEG 2000 on the card."""
from .base import Conversion, Converter, ConverterError, output_path
from .cuda import CudaConverter

__all__ = ["Conversion", "Converter", "ConverterError", "CudaConverter",
           "output_path"]
