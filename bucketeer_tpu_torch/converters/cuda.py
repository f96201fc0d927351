"""The in-process CUDA converter: TIFF -> JP2/JPX with the reference's
Kakadu recipe (converters/KakaduConverter.java:38-44): ``Clevels=6
Clayers=6 Cprecincts={256,256},{256,256},{128,128} Stiles={512,512}
Corder=RPCL ORGgen_plt=yes ORGtparts=R Cblk={64,64} Cuse_sop=yes
Cuse_eph=yes``; lossless = reversible 5/3 + RCT, lossy = irreversible
9/7 + ICT with PCRD-opt truncation to 3 bpp (``-rate 3``).
"""
from __future__ import annotations

import os

from ..codec import tiff
from ..codec.encoder import EncodeParams, encode_jp2
from .base import Conversion, ConverterError, output_path

LOSSY_RATE = 3.0    # reference: -rate 3 (KakaduConverter.java:43)


class CudaConverter:
    """JPEG 2000 encoding on one CUDA device (or, for tests, the CPU)."""

    name = "CUDA"

    def __init__(self, device="cuda", device_cxd: bool | None = None,
                 device_mq: bool | None = None,
                 lossy_rate: float = LOSSY_RATE, jpx: bool = True) -> None:
        self.device = device
        # Tier-1 placement, passed into EncodeParams as the JAX
        # package's TpuConverter does: device_mq=False with
        # device_cxd=True runs the CX/D split (device scan, host MQ
        # replay); the defaults run the fused device Tier-1.
        self.device_cxd = device_cxd
        self.device_mq = device_mq
        self.lossy_rate = lossy_rate
        self.jpx = jpx
        self.last_stats: dict = {}

    def convert(self, image_id: str, source_path: str,
                conversion: Conversion = Conversion.LOSSLESS) -> str:
        """Convert one source image to a JP2/JPX derivative; returns its
        path. ``last_stats`` then holds the encode's Tier-1 volume
        (code-blocks, symbols, MQ bytes)."""
        if not os.path.exists(source_path):
            raise ConverterError(f"source not found: {source_path}")
        try:
            img, bitdepth = tiff.read_image(source_path)
        except Exception as exc:
            raise ConverterError(
                f"cannot read {source_path}: {exc}") from exc

        h, w = img.shape[:2]
        params = EncodeParams.kakadu_recipe(
            lossless=conversion == Conversion.LOSSLESS,
            rate=self.lossy_rate)
        params.device_cxd = self.device_cxd
        params.device_mq = self.device_mq
        # Tiny images can't sustain 6 levels; clamp like encoders do.
        while params.levels > 1 and (min(h, w) >> params.levels) < 4:
            params.levels -= 1
        if max(h, w) <= params.tile_size:
            params.tile_size = None         # single tile, like kdu untiled
        # The base step is calibrated for 8-bit signals; scale it with
        # the signal range so deeper scans quantize proportionally.
        params.base_delta *= (1 << (bitdepth - 8))
        stats: dict = {}
        try:
            data = encode_jp2(img, bitdepth, params, jpx=self.jpx,
                              device=self.device, stats=stats)
        except Exception as exc:
            raise ConverterError(
                f"encode failed for {image_id}: {exc}") from exc
        self.last_stats = stats

        dest = output_path(image_id, ".jpx" if self.jpx else ".jp2")
        # Unique temp name: concurrent converts of the same id must not
        # interleave writes before the atomic replace.
        tmp = f"{dest}.{os.getpid()}.{id(data):x}.part"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, dest)
        return dest
