"""``single_image``: one closed-loop client sending single-image requests
to the engine's ``IMAGE_WORKER`` bus address, as ``/images/{id}/{path}``
does, each naming the next of ``sources`` seeded TIFFs; a request ends
when its JP2 has landed in the fake bucket."""
from __future__ import annotations

import asyncio
import time

from benchmark.harness import traffic


class Kind(traffic.Base):
    async def setup(self) -> None:
        self.make_sources(self.mix["sources"])
        self.engine = traffic.engine(self.ctx.workdir, self.ctx.device,
                                     self.conversion)
        await self.engine.start()
        self.issued = []           # (image id, source index, acknowledged)
        await self._one("warm-0", 0)

    async def _one(self, image_id: str, src: int) -> bool:
        from bucketeer_tpu_torch import constants as c
        from bucketeer_tpu_torch.engine import IMAGE_WORKER
        reply = await self.engine.bus.request_with_retry(IMAGE_WORKER, {
            c.IMAGE_ID: image_id, c.FILE_PATH: self.sources[src][0],
            c.CONVERSION_TYPE: self.conversion, c.REQUEST_ID: image_id})
        uploads = list(self.engine.image_worker.background)
        if uploads:
            await asyncio.gather(*uploads, return_exceptions=True)
        return reply.is_success

    async def run(self, window) -> None:
        n = 0
        while window.due():
            image_id = f"bench-{n:05d}"
            src = n % len(self.sources)
            t0 = time.perf_counter()
            ok = await self._one(image_id, src)
            window.add(t0, time.perf_counter(), pixels=self.pixels,
                       images=1, image_id=image_id, ok=ok)
            self.issued.append((image_id, src, ok))
            n += 1

    async def close(self) -> None:
        await self.engine.close()

    def check(self, rng, control: bool = False) -> dict:
        landed = []
        missing = 0
        for image_id, src, ok in self.issued:
            path = self.landed(image_id) if ok else None
            if path is None:
                missing += 1
            else:
                landed.append((path, src))
        res = self.judge_objects(landed, rng, control)
        res["missing"] = missing
        return res
