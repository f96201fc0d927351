"""Closed-loop kill-and-restart ingest driver (the chaos smoke).

``python -m bucketeer_tpu_torch.engine.chaos --workdir D --items 4
--seed 7 --kill-after 1`` runs a real batch ingest (CSV -> dispatch ->
stub convert -> fake S3 -> status -> finalize) over a journal-backed
:class:`~.store.JobStore` and, via a fault plan (:mod:`.faults`),
hard-kills the process (``os._exit(137)``) in the at-least-once window
— after the ``kill-after``-th item resolved, while later items sit
dispatched-but-unresolved. A second invocation with ``--resume`` on the
same workdir replays the journal, re-queues the surviving items,
finalizes the job, and prints a JSON summary with the output CSV's
sha256 — byte-identical across two replays of the same seed, and equal
to the JAX package's CLI for the same seed.

Everything that could wiggle is pinned: deterministic source bytes and
derivative bytes (sha256 of the item id), one batch-converter instance,
seeded retry jitter, and a fault trace (``--trace``) recording every
injection decision.
"""
from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import sys

from .. import config as cfg
from .. import constants as c
from .. import features, job_factory
from ..utils import path_prefix as pp
from . import faults
from .batch import BatchConverterWorker, start_job
from .bus import MessageBus
from .retry import RetryPolicy
from .s3 import FakeS3Client, S3UploadWorker, S3UploaderConfig
from .slack import RecordingSlackClient, SlackWorker
from .store import Counters, JobStore, UploadsMap
from .workers import (FINALIZE_JOB, FinalizeJobWorker, ItemFailureWorker)

JOB_NAME = "chaos-job"
KILL_EXIT = 137


class _StubConverter:
    """Deterministic instant 'conversion': derivative bytes are a pure
    function of the item id, so replays are byte-identical."""

    def __init__(self, outdir: str) -> None:
        self.outdir = outdir

    def convert(self, image_id: str, source_path: str,
                conversion=None) -> str:
        out = os.path.join(self.outdir,
                           image_id.replace("/", "_") + ".jpx")
        with open(out, "wb") as fh:
            fh.write(b"JPX" + hashlib.sha256(
                image_id.encode()).hexdigest().encode())
        return out


def _build_world(workdir: str, items: int):
    src = os.path.join(workdir, "src")
    out = os.path.join(workdir, "out")
    deriv = os.path.join(workdir, "deriv")
    for d in (src, out, deriv):
        os.makedirs(d, exist_ok=True)
    names = []
    for i in range(items):
        name = f"img{i}.tif"
        with open(os.path.join(src, name), "wb") as fh:
            fh.write(b"II*\x00" + hashlib.sha256(
                name.encode()).digest())
        names.append(name)
    csv_text = "Item ARK,File Name\n" + "\n".join(
        f"ark:/chaos/{i},{n}" for i, n in enumerate(names)) + "\n"
    config = cfg.Config.load(overrides={
        cfg.FILESYSTEM_CSV_MOUNT: out,
        cfg.IIIF_URL: "http://iiif.chaos/iiif",
        cfg.SLACK_CHANNEL_ID: "chaos",
        cfg.S3_REQUEUE_DELAY: 0.02,
    })
    flags = features.FeatureFlagChecker(
        static={features.FS_WRITE_CSV: True})
    return src, out, deriv, csv_text, config, flags


async def _run(args) -> dict:
    workdir = args.workdir
    journal_dir = os.path.join(workdir, "journal")
    src, out, deriv, csv_text, config, flags = _build_world(
        workdir, args.items)

    store = JobStore(journal_dir=journal_dir)
    recovery: dict = dict(store.recovery)
    bus = MessageBus(retry_delay=0.02,
                     retry_policy=RetryPolicy(max_attempts=8,
                                              base_delay=0.02,
                                              max_delay=0.2),
                     seed=args.seed)
    counters, uploads = Counters(), UploadsMap()
    s3 = FakeS3Client(os.path.join(workdir, "s3"))
    S3UploadWorker(s3, S3UploaderConfig(bucket="chaos", max_retries=4),
                   counters, uploads).register(bus)
    conv = _StubConverter(deriv)
    # One converter instance: the resolve order (and so the kill point)
    # is deterministic.
    BatchConverterWorker(conv, store, bus, config,
                         counters=counters).register(bus, instances=1)
    ItemFailureWorker(store, bus).register(bus)
    FinalizeJobWorker(store, bus, config, flags).register(bus)
    SlackWorker(RecordingSlackClient()).register(bus)

    pre = {"jobs": store.names()}
    if args.resume:
        # Journal recovery already repopulated the store; account for
        # what survived the kill *before* re-driving it.
        job = store.maybe_get(JOB_NAME)
        if job is None:
            raise SystemExit(f"--resume but no recovered job in "
                             f"{journal_dir}")
        pre["resolved_at_recovery"] = \
            len(job.items) - job.remaining()
        pre["dispatched_unresolved_at_recovery"] = \
            len(store.dispatched(JOB_NAME))
        if job.remaining() == 0:
            await bus.send(FINALIZE_JOB, {c.JOB_NAME: JOB_NAME})
        else:
            await start_job(job, bus, config, flags, store=store)
    else:
        job = job_factory.create_job(
            JOB_NAME, csv_text, prefix=pp.GenericFilePathPrefix(src))
        job.slack_handle = "gremlin"
        async with store.locked():
            store.put(job)
        await start_job(job, bus, config, flags, store=store)

    for _ in range(int(args.timeout / 0.02)):
        if JOB_NAME not in store:
            break
        await asyncio.sleep(0.02)
    else:
        raise SystemExit(
            f"job did not finalize within {args.timeout}s "
            f"(remaining={store.get(JOB_NAME).remaining()})")
    await bus.close()
    store.close()

    csv_path = os.path.join(out, f"{JOB_NAME}.csv")
    with open(csv_path, "rb") as fh:
        csv_bytes = fh.read()
    states = [row.rsplit(",", 2)[-2] for row in
              csv_bytes.decode().strip().splitlines()[1:]]
    return {
        "phase": "resume" if args.resume else "fresh",
        "recovery": recovery,
        **pre,
        "items": args.items,
        "states": {s: states.count(s) for s in sorted(set(states))},
        "uploads": len(s3.metadata),
        "dead_letters": len(bus.dead_letters),
        "csv_path": csv_path,
        "csv_sha256": hashlib.sha256(csv_bytes).hexdigest(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="kill-and-restart ingest chaos smoke")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--items", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-after", type=int, default=None,
                    help="hard-kill (exit 137) at the status write of "
                         "item N+1 — N items durably resolved, the "
                         "rest dispatched-unresolved")
    ap.add_argument("--resume", action="store_true",
                    help="recover the journal in --workdir and finish "
                         "the job")
    ap.add_argument("--scenario", default=None,
                    help="also install a named seeded fault scenario "
                         f"({', '.join(sorted(faults.SCENARIOS))})")
    ap.add_argument("--trace", default=None,
                    help="write the fault-decision trace JSON here")
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)

    plan = None
    if args.kill_after is not None:
        plan = faults.FaultPlan(args.seed).at(
            "batch.status", after=args.kill_after, hard_exit=KILL_EXIT)
    elif args.scenario:
        plan = faults.make_plan(args.scenario, args.seed)
    if plan is not None:
        plan.trace_path = args.trace
        faults.install(plan)
    try:
        report = asyncio.run(_run(args))
    finally:
        if plan is not None:
            plan.flush_trace()
            faults.install(None)
    json.dump(report, sys.stdout, indent=1, sort_keys=True)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
