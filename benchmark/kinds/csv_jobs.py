"""``csv_jobs``: CSV jobs of ``items_per_job`` items (the sources in
turn, each under its own ARK) through ``job_factory.create_job`` and
``start_job``, back to back; a job ends when ``FINALIZE_JOB`` has sent
its Slack message."""
from __future__ import annotations

import asyncio
import csv
import io
import os
import time

from benchmark.harness import traffic


class Kind(traffic.Base):
    async def setup(self) -> None:
        self.make_sources(self.mix["sources"])
        self.engine = traffic.engine(self.ctx.workdir, self.ctx.device,
                                     self.conversion)
        await self.engine.start()
        self.jobs = []             # (name, [(ark, source index)])
        await self._job("warm-job", self.mix["warm_items"])
        self.jobs.clear()

    async def _job(self, name: str, items: int) -> None:
        from bucketeer_tpu_torch import config as cfg
        from bucketeer_tpu_torch import job_factory
        from bucketeer_tpu_torch.engine import start_job
        from bucketeer_tpu_torch.utils import path_prefix
        rows = [(f"ark:/bench/{name}-{k}", k % len(self.sources))
                for k in range(items)]
        text = "Item ARK,File Name\n" + "".join(
            f"{ark},{os.path.basename(self.sources[s][0])}\n"
            for ark, s in rows)
        prefix = path_prefix.get_prefix(
            self.engine.config.get_str(cfg.FILESYSTEM_PREFIX),
            self.ctx.workdir)
        job = job_factory.create_job(name, text, prefix=prefix)
        job.slack_handle = "bench"
        async with self.engine.store.locked():
            await asyncio.to_thread(self.engine.store.put, job)
        self.jobs.append((name, rows))
        await start_job(job, self.engine.bus, self.engine.config,
                        self.engine.flags, conversion=self.conversion,
                        store=self.engine.store)
        # FINALIZE_JOB takes the job out of the store, writes its CSV and
        # then sends the Slack message: the job ends with the message.
        tag = f"'{name}'"
        while name in self.engine.store or not any(
                tag in m.get("text", "")
                for m in self.engine.slack_client.messages[-4:]):
            await asyncio.sleep(0.005)

    async def run(self, window) -> None:
        n = 0
        items = self.mix["items_per_job"]
        while window.due():
            t0 = time.perf_counter()
            await self._job(f"job{n:04d}", items)
            window.add(t0, time.perf_counter(), pixels=items * self.pixels,
                       images=items)
            n += 1

    async def close(self) -> None:
        await self.engine.close()

    def check(self, rng, control: bool = False) -> dict:
        from bucketeer_tpu_torch import config as cfg
        mount = self.engine.config.get_str(cfg.FILESYSTEM_CSV_MOUNT)
        texts = [m.get("text", "") for m in self.engine.slack_client.messages]
        unresolved = 0
        landed = []
        for name, rows in self.jobs:
            try:
                with open(os.path.join(mount, f"{name}.csv"),
                          encoding="utf-8") as fh:
                    table = {r.get("Item ARK"): r for r in
                             csv.DictReader(io.StringIO(fh.read()))}
            except OSError:
                table = {}
            if not any(f"'{name}'" in t for t in texts):
                unresolved += 1
            for ark, src in rows:
                row = table.get(ark) or {}
                path = self.landed(ark)
                if row.get("Bucketeer State") != "succeeded" or not \
                        row.get("IIIF Access URL") or path is None:
                    unresolved += 1
                else:
                    landed.append((path, src))
        res = self.judge_objects(landed, rng, control)
        res["unresolved"] = unresolved
        return res
