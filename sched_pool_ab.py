#!/usr/bin/env python3
"""Two concurrent CX/D-split encodes of 4096x4096 images against the
size of the scheduler's shared host Tier-1 pool, on one NVIDIA GPU.

    python3 sched_pool_ab.py [--seed N] [--pools 1 2] [--rounds 1]

Forms chip_smoke.py's two images (--seed and --seed + 1) and the pair
its phase 8 converts concurrently with the split (device_cxd=True,
device_mq=False; Kakadu recipe): image 1 lossy and image 2 lossless.
First the direct fused encode of each (the files every later encode
must equal), then each split encode alone with no scheduler (its solo
wall). Then the pair, released together by a barrier, in each arm:
through an EncodeScheduler(device="cuda", pool_size=P) for each P of
--pools, whose P workers run the MQ replay of both encodes, and with no
scheduler ("private": each encode replays on a one-worker executor of
its own). The arms run in turns, forward then backward, --rounds times.
Each pair prints its wall (card synchronized), the process's CPU
seconds over that wall (cores busy on average), each encode's own wall,
and the replay threads per call. Exits non-zero without a result when
no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

import chip_smoke as smoke


def run_pair(fns: list) -> tuple:
    """The thunks in threads released together: (results, each thunk's
    wall, the pair's wall with the card synchronized, process CPU s)."""
    barrier = threading.Barrier(len(fns) + 1)
    outs = [None] * len(fns)
    walls = [0.0] * len(fns)
    errs = [None] * len(fns)

    def client(i):
        barrier.wait()
        t0 = time.perf_counter()
        try:
            outs[i] = fns[i]()
        except BaseException as exc:
            errs[i] = exc
        walls[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    barrier.wait()
    t0, c0 = time.perf_counter(), time.process_time()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            smoke.fail("a client hung")
    torch.cuda.synchronize()
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    for e in errs:
        if e is not None:
            smoke.fail(f"an encode failed: {e!r}")
    return outs, walls, wall, cpu


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--pools", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: no CUDA device")
    from bucketeer_tpu_torch.codec import encoder, t1_batch
    from bucketeer_tpu_torch.converters import Conversion, CudaConverter
    from bucketeer_tpu_torch.engine.scheduler import EncodeScheduler

    card = smoke.phase_card()
    smoke.phase_build()
    size = smoke.SIZE
    imgs = {1: smoke.photo(np.random.default_rng(args.seed), size, size),
            2: smoke.photo(np.random.default_rng(args.seed + 1), size,
                           size)}
    jobs = [(1, Conversion.LOSSY), (2, Conversion.LOSSLESS)]
    fused, split = CudaConverter(), CudaConverter(device_cxd=True,
                                                  device_mq=False)
    want, solo = {}, {}
    for i, c in jobs:
        want[i, c] = encoder.encode_jp2(
            imgs[i], 8, fused.encode_params(size, size, 8, c), jpx=True,
            device="cuda")
    params = {(i, c): split.encode_params(size, size, 8, c)
              for i, c in jobs}

    def direct(i, c):
        return encoder.encode_jp2(imgs[i], 8, params[i, c], jpx=True,
                                  device="cuda")

    for i, c in jobs:
        outs, walls, _, _ = run_pair([lambda i=i, c=c: direct(i, c)])
        if outs[0] != want[i, c]:
            smoke.fail(f"solo split image {i} {c.value} differs from the "
                       "direct fused encode")
        solo[i, c] = walls[0]
        smoke.say(f"pool ab: solo split image {i} {c.value} {walls[0]:.3f}"
                  " s (no scheduler)")

    arms = [f"pool {p}" for p in args.pools] + ["private"]
    order = (arms + arms[::-1]) * args.rounds
    rows = {a: [] for a in arms}
    for arm in order:
        sched = None
        if arm == "private":
            fns = [lambda i=i, c=c: direct(i, c) for i, c in jobs]
        else:
            sched = EncodeScheduler(device="cuda",
                                    pool_size=int(arm.split()[1]))
            fns = [lambda i=i, c=c: sched.encode_jp2(
                imgs[i], 8, params[i, c], jpx=True) for i, c in jobs]
        try:
            outs, walls, wall, cpu = run_pair(fns)
        finally:
            if sched is not None:
                sched.close()
        for (i, c), data in zip(jobs, outs):
            if data != want[i, c]:
                smoke.fail(f"{arm}: image {i} {c.value} differs from the "
                           "direct fused encode")
        rows[arm].append(wall)
        smoke.say(f"pool ab: {arm}: pair wall {wall:.3f} s, process CPU "
                  f"{cpu:.3f} s ({cpu / wall:.2f} cores busy), own walls "
                  + ", ".join(f"{w:.3f}" for w in walls) + f" s; "
                  f"{t1_batch.default_threads()} replay threads per call")
    total = sum(solo.values())
    smoke.say(json.dumps({
        "card": card, "solo_s": round(total, 3),
        "pair_s": {a: [round(w, 3) for w in v] for a, v in rows.items()},
        "pair_over_solo": {a: round(float(np.mean(v)) / total, 3)
                           for a, v in rows.items()}}))


if __name__ == "__main__":
    main()
