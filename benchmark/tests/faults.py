"""Faults planted under the timed path, for the tests (on the CPU) and
for reading a fault at a cell's own size on the card:

    python3 benchmark/tests/faults.py --fault half_tiles_empty \\
        --workload csv-lossy-2k --seed 7 --seconds 3

runs one cell once, as ``benchmark/run.py`` does, with the fault in
place; its result line should read ``"correct": false``.

A fault of the program is ``fault(patch)``, where ``patch(obj, name,
value)`` replaces an attribute (pytest's ``monkeypatch.setattr`` in the
tests); a fault of the service is ``fault(kind)``, applied after set-up.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402


def lsb_flipped(patch) -> None:
    """An answer altered where it is produced: the encoder's input with
    every sample's lowest bit flipped."""
    from bucketeer_tpu_torch.converters import cuda
    real = cuda.tiff.read_image

    def altered(path):
        img, depth = real(path)
        return img ^ 1, depth
    patch(cuda.tiff, "read_image", altered)


def half_tiles_empty(patch) -> None:
    """Half of the work left out inside a file: every other tile the
    encoder assembles gets no coding pass in any layer (empty packets),
    as a rate control that codes less would leave it."""
    from bucketeer_tpu_torch.codec import encoder, rate
    real = encoder._build_precincts
    calls = [0]

    def build(comp_res, origin, plan, exps, assigns_of):
        calls[0] += 1
        if calls[0] % 2:
            return real(comp_res, origin, plan, exps, assigns_of)

        def none(blk):
            n = len(assigns_of(blk).boundaries)
            return rate.LayerAssignment([(0, 0)] * n)
        return real(comp_res, origin, plan, exps, none)
    patch(encoder, "_build_precincts", build)


def second_shard_zeroed(patch) -> None:
    """The exchange between cards left out: every shard of the data mesh
    but the first arrives as zeros."""
    from bucketeer_tpu_torch.parallel import batch
    real = batch.batch_sharding

    def sharding(x, m):
        parts = real(x, m)
        return parts[:1] + [torch.zeros_like(p) for p in parts[1:]]
    patch(batch, "batch_sharding", sharding)


def half_uploads_dropped(kind) -> None:
    """Half of the batch left out: every other object the service
    uploads never lands."""
    s3 = kind.engine.s3_client
    real = s3.put
    n = [0]

    async def put(bucket, key, file_path, metadata=None):
        n[0] += 1
        if n[0] % 2:
            return None
        return await real(bucket, key, file_path, metadata)
    s3.put = put


def reads_changed(change):
    """A read's samples changed where they are returned: ``change`` maps
    the samples to what the viewer gets."""
    def fault(kind):
        real = kind.reader.read

        def read(path, reduce=0, layers=None, region=None):
            return change(np.asarray(real(path, reduce=reduce,
                                          layers=layers, region=region)))
        kind.reader.read = read
    return fault


PROGRAM = {"lsb_flipped": lsb_flipped, "half_tiles_empty": half_tiles_empty,
           "second_shard_zeroed": second_shard_zeroed}
SERVICE = {"half_uploads_dropped": half_uploads_dropped,
           "reads_plus_one": reads_changed(
               lambda a: (a.astype(np.int32) + 1).clip(
                   0, np.iinfo(a.dtype).max).astype(a.dtype))}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fault", required=True, choices=sorted(
        {**PROGRAM, **SERVICE}))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    args.trace, args.control = 0, 0
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cache = os.path.join(root, ".bench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, root)
    from benchmark.harness import cell
    if args.fault in PROGRAM:
        PROGRAM[args.fault](setattr)
    try:
        return cell.run(args, T_START, faults=SERVICE.get(args.fault))
    finally:
        sched = sys.modules.get("bucketeer_tpu_torch.engine.scheduler")
        if sched is not None and torch.cuda.is_available():
            sched.get_scheduler("cuda").close()


if __name__ == "__main__":
    sys.exit(main())
