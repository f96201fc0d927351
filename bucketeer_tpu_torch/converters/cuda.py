"""The in-process CUDA converter: TIFF -> JP2/JPX with the reference's
Kakadu recipe (converters/KakaduConverter.java:38-44): ``Clevels=6
Clayers=6 Cprecincts={256,256},{256,256},{128,128} Stiles={512,512}
Corder=RPCL ORGgen_plt=yes ORGtparts=R Cblk={64,64} Cuse_sop=yes
Cuse_eph=yes``; lossless = reversible 5/3 + RCT, lossy = irreversible
9/7 + ICT with PCRD-opt truncation to 3 bpp (``-rate 3``).
"""
from __future__ import annotations

import logging
import os
import threading

from .. import obs
from ..codec import tiff
from ..codec.encoder import EncodeParams
from . import tiff_source
from .base import Conversion, ConverterError, output_path

LOG = logging.getLogger(__name__)

LOSSY_RATE = 3.0    # reference: -rate 3 (KakaduConverter.java:43)

# Images at or above this pixel count route through a device mesh over
# every visible device of the converter's type whenever there are two or
# more: a single giant tile is row-sharded (parallel.sharded_dwt), a
# tiled image's batches are data-sharded (parallel.batch.
# run_tiles_sharded). The default is sized so ordinary scans stay on the
# single-device pipeline and only archival monsters (BASELINE config 4's
# 400 MPix maps) pay the mesh path. Override: the ``mesh_min_pixels``
# argument or the bucketeer.mesh.min.pixels config key (engine/batch.py).
DEFAULT_MESH_MIN_PIXELS = 64_000_000


class CudaConverter:
    """JPEG 2000 encoding on CUDA devices (or, for tests, the CPU).
    Every encode is one admitted request of a scheduler
    (engine/scheduler.py): ``scheduler``, else the process-wide one for
    ``device``'s type (``get_scheduler``). Images of ``mesh_min_pixels``
    or more go through a mesh over every visible device of that type
    when there are two or more (:meth:`_choose_mesh`)."""

    name = "CUDA"

    def __init__(self, device="cuda", device_cxd: bool | None = None,
                 device_mq: bool | None = None,
                 lossy_rate: float = LOSSY_RATE, jpx: bool = True,
                 scheduler=None, mesh_min_pixels: int | None = None) -> None:
        self.device = device
        self.mesh_min_pixels = (DEFAULT_MESH_MIN_PIXELS
                                if mesh_min_pixels is None
                                else mesh_min_pixels)
        # Tier-1 placement, passed into EncodeParams as the JAX
        # package's TpuConverter does: device_mq=False with
        # device_cxd=True runs the CX/D split (device scan, host MQ
        # replay), device_mq=False without it the host Tier-1 (bit-planes
        # packed on the card, coded on the host's cores); None leaves the
        # choice to the encoder (encoder._tier1_mode: the fused device
        # Tier-1 on a CUDA device, the host Tier-1 or the split elsewhere).
        self.device_cxd = device_cxd
        self.device_mq = device_mq
        self.lossy_rate = lossy_rate
        self.jpx = jpx
        self.scheduler = scheduler
        # Per thread: concurrent converts each read their own encode's.
        self._local = threading.local()

    @property
    def last_stats(self) -> dict:
        """The Tier-1 volume (code-blocks, symbols, MQ bytes) of the last
        convert this thread made through this converter."""
        return getattr(self._local, "stats", {})

    def encode_params(self, h: int, w: int, bitdepth: int,
                      conversion: Conversion) -> EncodeParams:
        """The Kakadu recipe for an h x w image of ``bitdepth`` bits, as
        :meth:`convert` encodes it."""
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
        return params

    def _choose_mesh(self, h: int, w: int, params: EncodeParams):
        """Mesh routing for over-threshold images: a ('data', 'tile')
        mesh over every visible device of the converter's type —
        all-spatial when the image is a single row-shardable tile,
        all-data otherwise. None keeps the single-device pipeline."""
        if self.mesh_min_pixels <= 0 or h * w < self.mesh_min_pixels:
            return None
        from ..parallel import mesh as mesh_mod
        from ..parallel.sharded_dwt import can_row_shard

        devices = mesh_mod.visible_devices(self.device)
        if len(devices) < 2:
            return None
        if params.tile_size is None:
            # A single tile can only parallelize spatially. If its rows
            # don't shard, a data mesh would pad the batch of one up to
            # n_devices full-size zero tiles (parallel/batch.py) — all
            # host memory and transfer, zero speedup — so stay on the
            # single-device pipeline instead.
            if can_row_shard(h, params.levels, len(devices)):
                return mesh_mod.make_mesh(devices,
                                          tile_parallel=len(devices))
            return None
        return mesh_mod.make_mesh(devices, tile_parallel=1)

    def convert(self, image_id: str, source_path: str,
                conversion: Conversion = Conversion.LOSSLESS, *,
                priority: int | None = None,
                deadline_s: float | None = None) -> str:
        """Convert one source image to a JP2/JPX derivative; returns its
        path. The encode waits for a slot of the scheduler at
        ``priority`` (default PRIORITY_SINGLE) within ``deadline_s``;
        QueueFull and DeadlineExceeded pass through, other failures
        raise ConverterError. ``last_stats`` then holds the encode's
        Tier-1 volume (code-blocks, symbols, MQ bytes)."""
        if not os.path.exists(source_path):
            raise ConverterError(f"source not found: {source_path}")
        # Deep TIFFs (16-bit RGB, big-endian 16-bit gray) take the port's
        # own reader: PIL would hand them back as 8-bit samples. Every
        # other source reads through PIL.
        try:
            with obs.span("convert.read") as sp:
                deep = tiff_source.deep(source_path)
                img, bitdepth = (tiff_source.read_image if deep
                                 else tiff.read_image)(source_path)
                if sp is not None:
                    sp.attrs.update(reader="deep" if deep else "pil",
                                    bitdepth=bitdepth,
                                    components=img.shape[2]
                                    if img.ndim == 3 else 1,
                                    bytes=img.nbytes)
        except Exception as exc:
            raise ConverterError(
                f"cannot read {source_path}: {exc}") from exc

        # Imported here: the engine package imports the converters
        # (a module-level import would cycle).
        from ..engine import scheduler as sched_mod

        h, w = img.shape[:2]
        params = self.encode_params(h, w, bitdepth, conversion)
        mesh = self._choose_mesh(h, w, params)
        if mesh is not None:
            LOG.info("routing %s (%dx%d) through the device mesh %s",
                     image_id, w, h, mesh.shape)
        sched = self.scheduler or sched_mod.get_scheduler(self.device)
        stats: dict = {}
        try:
            with obs.span("convert.encode", image_id=image_id,
                          pixels=h * w):
                data = sched.encode_jp2(
                    img, bitdepth, params, jpx=self.jpx, mesh=mesh,
                    priority=(sched_mod.PRIORITY_SINGLE if priority is None
                              else priority),
                    deadline_s=deadline_s, device=self.device,
                    stats=stats)
        except (sched_mod.QueueFull, sched_mod.DeadlineExceeded):
            # Admission and deadline outcomes are protocol, not converter
            # failures: a server maps them to 503 + Retry-After.
            raise
        except Exception as exc:
            raise ConverterError(
                f"encode failed for {image_id}: {exc}") from exc
        self._local.stats = stats

        dest = output_path(image_id, ".jpx" if self.jpx else ".jp2")
        # Unique temp name: concurrent converts of the same id must not
        # interleave writes before the atomic replace.
        tmp = f"{dest}.{os.getpid()}.{id(data):x}.part"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, dest)
        return dest
