#!/usr/bin/env python3
"""Phase 11's mesh and batch checks of chip_smoke.py across every card of
the machine (halos and shards copied peer to peer between cards), each
against its single-device run; needs two cards or more.

    python3 mesh_cards.py [--seam-only]

(a) phase 5's 4096x4096 image as one tile, lossless, 6 levels, rows over
every card, twice, each file equal to the single-device encode; the lossy
transform across the cards against run_tiles on cuda:0. (b) the 8192x8192
TIFF of phase 11 through CudaConverter(), which routes it over every card,
twice, equal to the unrouted convert. (c) a batch of one item per card at
reduce 4, split one item per card and equal to the coefficient reads.
(d) the mesh audit's copy seam (parallel/mesh.py) against what the cards
really copy: the two DWT mesh programs of analysis/graftmesh.py (gray and
RGB 256x64, 2 levels), rows split from cuda:0 over a 1xN mesh of distinct
cards, then the sharded levels, then the low band gathered on cuda:0;
for each kind (split, halo, gather) the seam's bytes between entries
equal the bytes of the aten copies from one card to another that a
dispatch mode records in the same window. --seam-only runs (d) alone.
"""
import argparse
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


class CardCopies:
    """A dispatch mode summing the output bytes of the copies whose
    input lies on one card and output on another."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self
        self.bytes = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.name().split("::")[-1].split(".")[0]
                if name in ("_to_copy", "copy_", "_copy_from"):
                    ins = [a for a in args if isinstance(a, torch.Tensor)]
                    src = ins[-1].device if ins else None
                    if (isinstance(out, torch.Tensor) and src is not None
                            and src.type == out.device.type == "cuda"
                            and src != out.device):
                        outer.bytes += out.numel() * out.element_size()
                return out

        self.mode = Mode()


def seam_against_recorder(cards) -> None:
    """(d): per kind, the copy seam's bytes between distinct entries
    against the recorder's card-to-card copy bytes."""
    from bucketeer_tpu_torch.parallel import mesh as mesh_mod
    from bucketeer_tpu_torch.parallel.sharded_dwt import _local_dwt

    n = len(cards)
    mesh = mesh_mod.make_mesh(cards, tile_parallel=n)
    rng = np.random.default_rng(0)
    for label, shape in (("gray", (256, 64)), ("rgb", (3, 256, 64))):
        x = torch.as_tensor(rng.integers(0, 256, shape).astype(np.int32),
                            device=cards[0])
        state = {}
        steps = (
            ("split", lambda: state.update(
                shards=mesh_mod.row_sharding(x, mesh, dim=-2))),
            ("halo", lambda: state.update(
                out=_local_dwt(2, True, state["shards"]))),
            ("gather", lambda: mesh_mod.unshard(state["out"][0], -2,
                                                cards[0])))
        for kind, step in steps:
            seen = []
            copies = CardCopies()
            old = mesh_mod.set_copy_recorder(
                lambda k, moves, axis: seen.append((k, moves)))
            try:
                with copies.mode:
                    step()
                torch.cuda.synchronize()
            finally:
                mesh_mod.set_copy_recorder(old)
            seam = sum(b for k, moves in seen if k == kind
                       for b, src, dst in moves
                       if src != dst and mesh_mod.HOST not in (src, dst))
            print(f"seam against recorder: {label} {kind} across {n} "
                  f"cards: seam {seam} B between entries, recorder "
                  f"{copies.bytes} B copied card to card; equal: "
                  f"{seam == copies.bytes}", flush=True)
            if seam != copies.bytes or not seam:
                cs.fail(f"the copy seam's {kind} bytes ({seam}) differ "
                        f"from the card-to-card copies ({copies.bytes})")


class NoEvents(contextlib.nullcontext):
    """No CUDA events: events recorded on one card do not time the
    others' work."""

    def ms(self):
        return float("nan")


if __name__ == "__main__":
    import dataclasses

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seam-only", action="store_true",
                    help="run check (d) alone")
    seam_only = ap.parse_args().seam_only

    from bucketeer_tpu_torch.batches import BatchRecipe, assemble_batch
    from bucketeer_tpu_torch.codec import encoder, pipeline
    from bucketeer_tpu_torch.converters import (Conversion, CudaConverter,
                                                CudaReader)
    from bucketeer_tpu_torch.engine import get_scheduler
    from bucketeer_tpu_torch.parallel import batch as pbatch
    from bucketeer_tpu_torch.parallel import make_mesh, visible_devices
    from bucketeer_tpu_torch.parallel import sharded_dwt as sdwt

    t_all = time.perf_counter()
    cs.phase_card()
    cs.phase_build()
    cards = visible_devices()
    n = len(cards)
    print(f"cards: {n} {[torch.cuda.get_device_name(i) for i in range(n)]}; "
          f"peer access 0->k: "
          f"{[torch.cuda.can_device_access_peer(0, k) for k in range(1, n)]}",
          flush=True)
    if n < 2:
        cs.fail("this check needs two cards or more")
    seed = 20261016
    img = cs.photo(np.random.default_rng(seed), cs.SIZE, cs.SIZE)
    img2 = cs.photo(np.random.default_rng(seed + 1), cs.SIZE, cs.SIZE)
    work = tempfile.mkdtemp(prefix="chip11x4-")
    os.environ["BUCKETEER_TMPDIR"] = work
    LL, LY = Conversion.LOSSLESS, Conversion.LOSSY
    conv = CudaConverter()
    h, w = img.shape[:2]

    seam_against_recorder(cards)
    if seam_only:
        raise SystemExit(0)
    # (a) one tile, rows over every card.
    params = dataclasses.replace(conv.encode_params(h, w, 8, LL),
                                 tile_size=None)
    spatial = make_mesh(tile_parallel=n)
    t0 = time.perf_counter()
    single = encoder.encode_jp2(img, 8, params, jpx=True, device="cuda")
    torch.cuda.synchronize()
    print(f"single-device one-tile encode {time.perf_counter() - t0:.3f} s",
          flush=True)
    for _ in range(2):
        got, _ = cs.mesh_encode(
            f"spatial {spatial.shape} across {n} cards",
            lambda: encoder.encode_jp2(img, 8, params, jpx=True,
                                       mesh=spatial, device="cuda"),
            cs.mesh_stages(sdwt, "sharded_transform_tile"), NoEvents(),
            h * w)
        print(f"spatial across cards: identical to the single-device "
              f"file: {got == single}", flush=True)
        if got != single:
            cs.fail("spatial across cards differs")
    lp = conv.encode_params(h, w, 8, LY)
    plan = pipeline.make_plan(
        h, w, 3, lp.levels, False, 8, lp.base_delta,
        use_mct=encoder._mct_helps(img, False, lp.rate, lp.base_delta))
    sharded = sdwt.sharded_transform_tile(plan, img, spatial)
    whole = pipeline.run_tiles(plan, img[None], device="cuda")[0]
    diff = np.abs(sharded.astype(np.int64) - whole)
    print(f"lossy transform across cards against run_tiles on cuda:0: max "
          f"|delta| {int(diff.max())}, {int(np.count_nonzero(diff))} of "
          f"{diff.size} differ", flush=True)
    if diff.max() > 1 or np.count_nonzero(diff) >= 0.01 * diff.size:
        cs.fail("lossy across cards strays")

    # (b) the converter routes an 8192^2 image over every card.
    big = cs.photo(np.random.default_rng(seed + 3), cs.MESH_SIZE,
                   cs.MESH_SIZE)
    src = os.path.join(work, "map.tif")
    cs.write_tiff(src, big)
    H = W = cs.MESH_SIZE
    route = conv._choose_mesh(H, W, conv.encode_params(H, W, 8, LL))
    print(f"converter mesh for {W}x{H}: {route.shape}", flush=True)
    t0 = time.perf_counter()
    with open(CudaConverter(mesh_min_pixels=0).convert("map1", src, LL),
              "rb") as fh:
        want = fh.read()
    print(f"single-device convert {time.perf_counter() - t0:.3f} s",
          flush=True)
    for k in range(2):
        with cs.StageTimer(cs.mesh_stages(pbatch, "run_tiles_sharded")) \
                as stt:
            t0 = time.perf_counter()
            with open(conv.convert(f"map-routed-{k}", src, LL), "rb") as fh:
                got = fh.read()
            wall = time.perf_counter() - t0
        print(f"routed convert across {n} cards: wall {wall:.3f} s, "
              f"{H * W / wall / 1e6:.3f} MPix/s = {stt.line()}; identical: "
              f"{got == want}", flush=True)
        if got != want:
            cs.fail("routed convert differs")

    # (c) a batch split over every card.
    f1 = encoder.encode_jp2(img, 8, conv.encode_params(h, w, 8, LL),
                            jpx=True, device="cuda")
    f2 = encoder.encode_jp2(img2, 8, conv.encode_params(h, w, 8, LL),
                            jpx=True, device="cuda")
    ids = [f"item{i}" for i in range(n)]
    blobs = {i: (f1 if k % 2 == 0 else f2) for k, i in enumerate(ids)}
    paths = {}
    for name, data in (("a", f1), ("b", f2)):
        paths[name] = os.path.join(work, f"{name}.jpx")
        with open(paths[name], "wb") as fh:
            fh.write(data)
    reader = CudaReader(device="cuda")
    refs = {k: reader.read_coefficients(p, reduce=4).to_host()
            for k, p in paths.items()}
    t0 = time.perf_counter()
    result = get_scheduler("cuda").submit_batchread(
        assemble_batch, BatchRecipe(ids=tuple(ids), reduce=4,
                                    layout="sharded"),
        data_for=blobs.get, device="cuda")
    torch.cuda.synchronize()
    print(f"batch of {n} over {result.meta['n_devices']} cards "
          f"({result.layout}) in {time.perf_counter() - t0:.3f} s", flush=True)
    host = result.to_host()
    for key, arr in host.items():
        want_band = np.stack([refs["a" if k % 2 == 0 else "b"][key]
                              for k in range(n)])
        if not np.array_equal(arr, want_band):
            cs.fail(f"batch band {key} differs")
        devs = [str(p.device) for p in result.bands[key]]
        if devs != [f"cuda:{k}" for k in range(n)]:
            cs.fail(f"batch band {key} lies on {devs}")
    print(f"batch: every band split one item per card and equal to the "
          f"coefficient reads; whole {time.perf_counter() - t_all:.1f} s",
          flush=True)
