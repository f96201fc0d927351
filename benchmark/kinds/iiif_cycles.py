"""``iiif_cycles``: one viewer reading a derivative that set-up encodes,
in cycles that each stand for a fresh image: caches dropped, ``dims``,
then each read of ``reads`` at positions drawn on the ``grid``; set-up
warms up with the cheaper ``warm`` reads, which run the same device
operations. The check holds every sample of every read to the reference
(``mismatch``); its control is the reference from samples one bit short,
put in the reads' place."""
from __future__ import annotations

import asyncio
import time

import numpy as np

from benchmark.harness import images, traffic
from benchmark.reference import j2k, judge


def _differ(got: np.ndarray, want: np.ndarray) -> int:
    if got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


class Kind(traffic.Base):
    async def setup(self) -> None:
        from bucketeer_tpu_torch.converters import (Conversion,
                                                    CudaConverter,
                                                    CudaReader)
        from bucketeer_tpu_torch.engine import get_scheduler
        self.make_sources(1)
        conv = CudaConverter(device=self.ctx.device)
        self.path = await asyncio.to_thread(
            conv.convert, "iiif-source", self.sources[0][0],
            Conversion(self.conversion))
        self.reader = CudaReader(device=self.ctx.device,
                                 scheduler=get_scheduler(self.ctx.device),
                                 metrics=self.ctx.sink)
        self.reads = []            # (reduce, region, samples)
        self.dims = []
        self._cycle(np.random.default_rng(images.seed_of(self.ctx.seed, 3)),
                    self.mix["warm"])
        self.reads.clear()
        self.dims.clear()
        self.rng = np.random.default_rng(images.seed_of(self.ctx.seed, 2))

    def _cycle(self, rng, reads: list) -> int:
        grid = self.mix["grid"]
        self.reader.reset_caches(tiles=True, index=True)
        self.dims.append(self.reader.dims(self.path))
        for spec in reads:
            region = None
            if "region" in spec:
                size = spec["region"]
                x = int(rng.integers((self.w - size) // grid + 1)) * grid
                y = int(rng.integers((self.h - size) // grid + 1)) * grid
                region = (x, y, size, size)
            out = self.reader.read(self.path, reduce=spec["reduce"],
                                   region=region)
            self.reads.append((spec["reduce"], region, np.asarray(out)))
        return len(reads)

    async def run(self, window) -> None:
        while window.due():
            t0 = time.perf_counter()
            n = self._cycle(self.rng, self.mix["reads"])
            window.add(t0, time.perf_counter(), reads=n)

    async def close(self) -> None:
        pass

    def check(self, rng, control: bool = False) -> dict:
        with open(self.path, "rb") as fh:
            stream = j2k.Stream(fh.read())
        img = self.sources[0][1]
        bad_dims = sum(d != (self.w, self.h) for d in self.dims)
        res = {"mismatch": bad_dims, "reads": len(self.reads)}
        if control:
            res["control.mismatch"] = bad_dims
        tiles: dict = {}
        for reduce, region, got in self.reads:
            want = judge.read_truth(img, stream.tile_w, reduce, region,
                                    bool(stream.mct), self.bitdepth,
                                    cache=tiles)
            if got.ndim == 2:
                got = got[..., None]
            res["mismatch"] += _differ(got, want)
            if control:
                other = judge.read_truth(img, stream.tile_w, reduce, region,
                                         bool(stream.mct), self.bitdepth,
                                         bit_short=True, cache=tiles)
                res["control.mismatch"] += _differ(other, want)
        return res
