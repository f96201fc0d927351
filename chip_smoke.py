#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bucketeer_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds, is right and runs
its main path on the card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit (nvidia-smi);
2. nvcc build of every kernel of the path (csrc/fused_t1.cu);
3. each kernel against its plain PyTorch version on the same inputs:
   synthetic launch groups at L in {8, 16, 32}, frac in {0, 7}, every
   band class, partial, all-zero and floored-dead blocks, each 64x64 at
   most (plain side on the host CPU), then one real launch group cut
   from the full-size image's own front-end output (plain side on the
   card);
4. slice parity: a 256x256 RGB image through the Kakadu recipe, both
   conversions, encode_jp2 on the card byte-identical to encode_jp2 on
   the CPU (where every kernel runs its plain version);
5. the main path: a 4096x4096 8-bit RGB TIFF (BASELINE config 1's
   size) made from --seed through CudaConverter().convert, lossless and
   lossy, after one warm-up, with wall time, MPix/s, kernel launches and
   time, Tier-1 volume and peak device memory; then one synchronized
   convert of each kind timed stage by stage, whose lossy run hands its
   largest L=8 and L=16 launch groups (frac 7, the rate estimator's
   floors) to a second kernel-against-plain check on the card;
6. one JSON line per kernel, then the card line and the result line.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit peak
FUSED_T1_SRC = "bucketeer_tpu_torch/csrc/fused_t1.cu"
FUSED_T1_TPU = "bucketeer_tpu/codec/pallas/fused_t1.py:72"
SIZE = 4096                    # BASELINE config 1: 4096x4096 RGB


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def photo(rng, h: int, w: int) -> np.ndarray:
    """A scan-like 8-bit RGB image: smooth structure, edges and sensor
    noise, made from ``rng``."""
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    base = (0.45 + 0.2 * np.sin(x / 97.0) * np.cos(y / 61.0)
            + 0.15 * np.sign(np.sin(x / 413.0 + y / 251.0)))
    out = np.empty((h, w, 3), np.uint8)
    for c in range(3):
        chan = base * (200.0 + 20.0 * c) + rng.normal(0, 5.0, (h, w))
        out[..., c] = np.clip(chan, 0, 255).astype(np.uint8)
    return out


def write_tiff(path: str, img: np.ndarray) -> None:
    """Uncompressed baseline RGB TIFF, one strip, little-endian."""
    h, w, _ = img.shape
    data = np.ascontiguousarray(img).tobytes()
    n_tags = 10
    ifd_at = 8
    bps_at = ifd_at + 2 + 12 * n_tags + 4
    data_at = bps_at + 6
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, bps_at),
            (259, 3, 1, 1), (262, 3, 1, 2), (273, 4, 1, data_at),
            (277, 3, 1, 3), (278, 4, 1, h), (279, 4, 1, len(data)),
            (284, 3, 1, 1)]
    with open(path, "wb") as fh:
        fh.write(b"II*\0" + struct.pack("<I", ifd_at))
        fh.write(struct.pack("<H", n_tags))
        for tag, typ, count, value in tags:
            packed = (struct.pack("<HH", value, 0) if typ == 3 and count == 1
                      else struct.pack("<I", value))
            fh.write(struct.pack("<HHI", tag, typ, count) + packed)
        fh.write(struct.pack("<I", 0))
        fh.write(struct.pack("<HHH", 8, 8, 8))
        fh.write(data)


# --- phase 3: kernel against plain ------------------------------------

def synthetic_group(rng, L: int, frac: int):
    """A launch group holding every kind of block: full and partial
    extents, the three band classes, all-zero, floored-dead and partly
    floored blocks. Sparse and few, because the plain side is slow."""
    depth = {8: 8, 16: 12, 32: 18}[L]
    edge = 64
    hw = [(edge, edge), (edge // 2 + 3, edge - 5), (edge, 5), (7, edge),
          (9, 9), (edge, edge), (edge - 1, edge // 3 + 1), (edge, edge)]
    n = len(hw)
    blocks = np.zeros((n, 64, 64), np.int64)
    for i, (h, w) in enumerate(hw):
        dens = 0.12 if i == 0 else 0.05
        mags = (rng.random((h, w)) < dens) * rng.integers(
            0, 1 << (depth + frac), size=(h, w))
        blocks[i, :h, :w] = mags * np.where(rng.random((h, w)) < 0.5,
                                            -1, 1)
    blocks[4] = 0                                   # all-zero
    idx = np.abs(blocks) >> frac
    nbps = np.array([int(b.max()).bit_length() for b in idx], np.int32)
    floors = np.zeros(n, np.int32)
    floors[5] = nbps[5]                             # floored dead
    floors[6] = 2                                   # partly floored
    cls = np.array([0, 1, 2, 0, 1, 2, 0, 1], np.int32)
    hs = np.array([h for h, _ in hw], np.int32)
    ws = np.array([w for _, w in hw], np.int32)
    return [torch.as_tensor(a) for a in (blocks.astype(np.int32), nbps,
                                         floors, cls, hs, ws)]


def compare_outputs(L: int, got, ref) -> float:
    """Exact comparison of the seven outputs (bytes inside each block's
    data window only). Returns the max absolute difference seen, which
    must be 0."""
    from bucketeer_tpu_torch.kernels import fused_t1 as ft

    got = [g.cpu() for g in got]
    ref = [r.cpu() for r in ref]
    n = got[1].shape[0]
    cap = ft.mq_capacity(ft.max_syms(L))
    err = 0.0
    g_rows, r_rows = got[0].reshape(n, cap), ref[0].reshape(n, cap)
    for b in range(n):
        d = int(ref[2][b])
        diff = (g_rows[b, 1:1 + d].to(torch.int32)
                - r_rows[b, 1:1 + d].to(torch.int32)).abs()
        if diff.numel():
            err = max(err, float(diff.max()))
    for k in (1, 2, 3, 4, 5, 6):
        diff = (got[k].to(torch.float64) - ref[k].to(torch.float64)).abs()
        if diff.numel():
            err = max(err, float(diff.max()))
    # Distortion pairs must match bit for bit, signed zeros included.
    for k in (3, 4):
        if not torch.equal(got[k].view(torch.int32), ref[k].view(torch.int32)):
            err = max(err, 1.0)
    return err


def group_bound(L: int, hs, ws, dlen, cur) -> tuple:
    """Least time for one launch: each input byte read once (a block's
    h x w extent, not its 64x64 slot) and each meaningful output byte
    written once at HBM rate, against one 32-bit operation per coded
    decision at the non-tensor peak."""
    n = hs.shape[0]
    bytes_in = (int((hs.to(torch.int64) * ws.to(torch.int64)).sum()) * 4
                + n * 5 * 4)
    bytes_out = (int((dlen.to(torch.int64) + 1).sum()) + n * L * 3 * 4 * 3
                 + n * 3 * 4)
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    t_ops = int(cur.to(torch.int64).sum()) / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), bytes_in + bytes_out


def time_kernel(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class LaunchTimer:
    """Wraps the fused_t1 wrapper as codec/cxd.py calls it: CUDA events
    around each launch, plus each launch's volume for the bound."""

    def __init__(self, fn):
        self.fn = fn
        self.launches = []

    def __call__(self, L, frac, blocks, *meta):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(L, frac, blocks, *meta)
        stop.record()
        self.launches.append((start, stop, L, meta[3], meta[4], out[2],
                              out[5]))
        return out

    def kernel_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e, *_ in self.launches)

    def bound_ms(self) -> float:
        return sum(group_bound(L, hs, ws, dlen, cur)[0]
                   for _, _, L, hs, ws, dlen, cur in self.launches)


class GroupCapture:
    """Wraps the fused_t1 wrapper as codec/cxd.py calls it and keeps the
    largest launch group at each plane budget L (its inputs, as the
    encoder formed them): {L: (frac, args)}."""

    def __init__(self, fn):
        self.fn = fn
        self.groups = {}

    def __call__(self, L, frac, *args):
        old = self.groups.get(L)
        if old is None or args[0].shape[0] > old[1][0].shape[0]:
            self.groups[L] = (frac, args)
        return self.fn(L, frac, *args)


class StageTimer:
    """Host wall time per stage of an encode, by wrapping the module
    functions the encoder calls; each wrapper synchronizes the card on
    entry and exit, so device work lands in the stage that queued it
    (and chunks no longer overlap — this pass is for the breakdown, not
    for throughput)."""

    def __init__(self, stages):
        self.stages = stages            # [(label, module, attribute)]
        self.seconds = {label: 0.0 for label, _, _ in stages}
        self.calls = {label: 0 for label, _, _ in stages}
        self._saved = []

    def _wrap(self, label, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.seconds[label] += time.perf_counter() - t0
                self.calls[label] += 1
        return timed

    def __enter__(self):
        for label, mod, attr in self.stages:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(label, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)


def first_chunk_groups(img: np.ndarray):
    """The first chunk of the image's lossless encode, as encode_array
    forms it: its front-end output on the card and its launch groups."""
    from bucketeer_tpu_torch.codec import cxd, encoder, frontend
    from bucketeer_tpu_torch.codec.pipeline import make_plan

    params = encoder.EncodeParams.kakadu_recipe(lossless=True)
    mct = encoder._mct_helps(img, True, None, params.base_delta)
    plan = make_plan(params.tile_size, params.tile_size, 3, params.levels,
                     True, 8, params.base_delta, use_mct=mct)
    t = params.tile_size
    batch = np.stack([img[0:t, x:x + t] for x in
                      range(0, min(img.shape[1], encoder.CHUNK_TILES * t),
                            t)])
    fres = frontend.dispatch_frontend(plan, batch, "cuda").resolve_stats()
    layout = frontend.layout_for(plan)
    names = [plan.slots[m.slot_i].name for m in layout.metas] * len(batch)
    hs = np.asarray([m.h for m in layout.metas] * len(batch), np.int32)
    ws = np.asarray([m.w for m in layout.metas] * len(batch), np.int32)
    floors = np.zeros(fres.n_blocks, np.int32)
    return list(cxd._group_launches(fres.blocks, fres.nbps, floors, names,
                                    hs, ws))


# --- phases -----------------------------------------------------------

def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = out.stdout.strip().splitlines()[0]
    say(f"card: {line}")
    return line


def phase_build() -> None:
    from bucketeer_tpu_torch.kernels import fused_t1 as ft

    t0 = time.perf_counter()
    lib = ft.KERNEL.build()
    ft.KERNEL.library()
    say(f"build: fused_t1 {time.perf_counter() - t0:.2f} s "
        f"(nvcc {ft.KERNEL.build_seconds:.2f} s) -> "
        f"{os.path.relpath(lib)}")
    for line in ft.KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"build: ptxas: {line.strip()}")


def phase_kernel_vs_plain(rng, img) -> dict:
    from bucketeer_tpu_torch.kernels import fused_t1 as ft

    worst = 0.0
    for L in (8, 16, 32):
        for frac in (0, 7):
            cpu = synthetic_group(rng, L, frac)
            t0 = time.perf_counter()
            got = ft.fused_t1(L, frac, *(a.cuda() for a in cpu))
            torch.cuda.synchronize()
            t_k = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = ft.fused_t1(L, frac, *cpu)       # CPU: plain version
            t_p = time.perf_counter() - t0
            err = compare_outputs(L, got, ref)
            worst = max(worst, err)
            say(f"kernel-vs-plain: synthetic L={L} frac={frac} "
                f"blocks={cpu[0].shape[0]} symbols="
                f"{int(ref[5].sum())} max_abs_err={err} (tolerance 0) "
                f"(kernel {t_k:.3f} s, plain on host {t_p:.1f} s)")
            if err != 0:
                fail(f"fused_t1 differs from its plain version at L={L} "
                     f"frac={frac}")

    # One real launch group of the full-size image: the largest of its
    # first lossless chunk.
    groups = first_chunk_groups(img)
    L, _, args = max(groups, key=lambda g: len(g[1]))
    res = check_image_group("lossless first chunk", L, 0, args)
    got = res.pop("got")
    # The serial chain: the group's longest block launched alone (one
    # thread, no other lane in its warp) — the least time any schedule
    # of this group could take with one thread per block.
    b = int(torch.argmax(got[5]))
    one = [a[b:b + 1].contiguous() for a in args]
    chain_ms = time_kernel(lambda: ft.fused_t1(L, 0, *one))
    say(f"kernel serial chain: longest block of the group alone "
        f"({int(got[5][b])} decisions, {int(got[2][b])} bytes): "
        f"{chain_ms:.3f} ms, {chain_ms * 1e6 / max(int(got[5][b]), 1):.1f}"
        f" ns per decision")
    res["max_abs_err"] = max(worst, res["max_abs_err"])
    return res


def check_image_group(label: str, L: int, frac: int, args) -> dict:
    """Time one real launch group on the card and hold the kernel's
    outputs against the plain version's, run on the card on the same
    inputs (tolerance 0)."""
    from bucketeer_tpu_torch.kernels import fused_t1 as ft

    ms = time_kernel(lambda: ft.fused_t1(L, frac, *args))
    got = ft.fused_t1(L, frac, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ft.fused_t1_plain(L, frac, *args)         # plain, on the card
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare_outputs(L, got, ref)
    bound, bound_by, moved = group_bound(L, args[4], args[5], got[2],
                                         got[5])
    floored = int((args[2] > 0).sum())
    say(f"kernel-vs-plain: image group ({label}) L={L} frac={frac} "
        f"blocks={args[0].shape[0]} (floored {floored}) "
        f"symbols={int(got[5].sum())} bytes={int(got[2].sum())} "
        f"max_abs_err={err} (tolerance 0); kernel {ms:.3f} ms, plain on "
        f"the card {plain_ms:.0f} ms, bound {bound:.6f} ms by {bound_by} "
        f"({moved} B)")
    if err != 0:
        fail(f"fused_t1 differs from its plain version on the image group "
             f"({label})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "got": got}


def phase_parity(rng) -> None:
    from bucketeer_tpu_torch.codec.encoder import EncodeParams, encode_jp2

    img = photo(rng, 256, 256)
    for lossless in (True, False):
        params = EncodeParams.kakadu_recipe(lossless=lossless)
        params.tile_size = None
        t0 = time.perf_counter()
        on_card = encode_jp2(img, 8, params, jpx=True, device="cuda")
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = encode_jp2(img, 8, params, jpx=True, device="cpu")
        t_cpu = time.perf_counter() - t0
        kind = "lossless" if lossless else "lossy"
        say(f"parity 256x256 {kind}: card {len(on_card)} B in "
            f"{t_card:.2f} s, cpu {len(on_cpu)} B in {t_cpu:.1f} s, "
            f"identical={on_card == on_cpu}")
        if on_card != on_cpu:
            fail(f"256x256 {kind}: card bytes differ from CPU bytes")


def check_jp2(data: bytes, img: np.ndarray, lossless: bool) -> str:
    """The file is a JP2/JPX with one complete codestream of the image's
    size; where PIL can decode JPEG 2000, the lossless file decodes back
    to the source exactly."""
    if not data.startswith(b"\0\0\0\x0cjP  \r\n\x87\n"):
        fail("output lacks the JP2 signature box")
    soc = data.find(b"\xff\x4f\xff\x51")
    if soc < 0 or not data.endswith(b"\xff\xd9"):
        fail("output lacks a complete codestream (SOC/SIZ ... EOC)")
    w, h = struct.unpack(">II", data[soc + 8:soc + 16])
    if (h, w) != img.shape[:2]:
        fail(f"codestream size {w}x{h} != image {img.shape[1]}x"
             f"{img.shape[0]}")
    from PIL import Image, features
    import io

    if not lossless or not features.check("jpg_2000"):
        return "structure ok"
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(io.BytesIO(data)) as im:
        back = np.asarray(im.convert("RGB"))
    if not np.array_equal(back, img):
        fail("lossless output does not decode to the source image")
    return "structure ok, decodes to the source exactly (OpenJPEG)"


def phase_main(img, workdir) -> dict:
    from bucketeer_tpu_torch.codec import cxd
    from bucketeer_tpu_torch.converters import Conversion, CudaConverter
    from bucketeer_tpu_torch.kernels import fused_t1 as ft

    h, w = img.shape[:2]
    src = os.path.join(workdir, "smoke.tif")
    write_tiff(src, img)
    conv = CudaConverter()
    t0 = time.perf_counter()
    conv.convert("smoke-warmup", src, Conversion.LOSSLESS)
    torch.cuda.synchronize()
    say(f"main: warm-up lossless convert {time.perf_counter() - t0:.2f} s")

    real = cxd.fused_t1
    ft.KERNEL.launches = 0
    totals = {"launches": 0}
    for conversion in (Conversion.LOSSLESS, Conversion.LOSSY):
        timer = LaunchTimer(real)
        cxd.fused_t1 = timer
        torch.cuda.reset_peak_memory_stats()
        before = ft.KERNEL.launches
        try:
            t0 = time.perf_counter()
            out = conv.convert(f"smoke-{conversion.value}", src, conversion)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            cxd.fused_t1 = real
        launches = ft.KERNEL.launches - before
        kms = timer.kernel_ms()
        st = conv.last_stats
        with open(out, "rb") as fh:
            data = fh.read()
        verdict = check_jp2(data, img, conversion == Conversion.LOSSLESS)
        say(f"main {conversion.value} {w}x{h}: wall {wall:.3f} s, "
            f"{h * w / wall / 1e6:.3f} MPix/s, {len(data)} B "
            f"({len(data) * 8 / (h * w):.3f} bpp); fused_t1 launches "
            f"{launches}, kernel {kms:.3f} ms total, "
            f"{kms / max(launches, 1):.3f} ms/launch, bound "
            f"{timer.bound_ms():.4f} ms; blocks {st['blocks']}, symbols "
            f"{st['symbols']}, bytes {st['bytes']}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
            f"{verdict}")
        if launches <= 0 or len(timer.launches) != launches:
            fail(f"{conversion.value}: the main path launched fused_t1 "
                 f"{launches} times")
        totals["launches"] += launches
    if ft.KERNEL.launches != totals["launches"]:
        fail("fused_t1 launch count does not match the main path's")
    totals["lossy_groups"] = phase_breakdown(conv, src)
    return totals


def phase_breakdown(conv, src: str):
    """One more convert of each kind with every stage synchronized and
    timed: where an encode's wall time goes. Returns the lossy convert's
    largest launch group at each plane budget, {L: (frac, kernel
    args)}."""
    from bucketeer_tpu_torch.codec import cxd, encoder, frontend, rate, tiff
    from bucketeer_tpu_torch.converters import Conversion

    stages = [("tiff read", tiff, "read_image"),
              ("mct choice", encoder, "_mct_helps"),
              ("front-end", frontend, "dispatch_frontend"),
              ("floor estimate", rate, "estimate_floors"),
              ("tier-1 (kernel)", cxd, "fused_t1"),
              ("tier-1 (fetch)", cxd, "_fetch_block_rows"),
              ("tier-1 (assembly)", cxd, "assemble_mq_blocks"),
              ("distortion rescale", encoder, "_correct_distortions"),
              ("pcrd + tier-2", encoder, "_finish")]
    real = cxd.fused_t1
    for conversion in (Conversion.LOSSLESS, Conversion.LOSSY):
        capture = cxd.fused_t1 = GroupCapture(real)
        try:
            with StageTimer(stages) as st:
                t0 = time.perf_counter()
                conv.convert(f"smoke-split-{conversion.value}", src,
                             conversion)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            cxd.fused_t1 = real
        parts = ", ".join(f"{k} {v:.3f} ({st.calls[k]}x)"
                          for k, v in st.seconds.items())
        rest = wall - sum(st.seconds.values())
        say(f"breakdown {conversion.value} (synchronized): wall "
            f"{wall:.3f} s = {parts}, other {rest:.3f} s")
    if not {8, 16} <= set(capture.groups):
        fail(f"the lossy convert launched groups at L in "
             f"{sorted(capture.groups)}, not at both 8 and 16")
    return capture.groups


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    import bucketeer_tpu_torch  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    rng = np.random.default_rng(args.seed)
    img = photo(rng, SIZE, SIZE)
    k = phase_kernel_vs_plain(rng, img)
    phase_parity(rng)
    workdir = tempfile.mkdtemp(prefix="chip-smoke-")
    os.environ["BUCKETEER_TMPDIR"] = workdir
    try:
        totals = phase_main(img, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    worst = k["max_abs_err"]
    for L in (8, 16):
        frac, group = totals["lossy_groups"][L]
        lossy = check_image_group("lossy, rate-estimator floors", L, frac,
                                  group)
        worst = max(worst, lossy["max_abs_err"])
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [{
        "name": "fused_t1", "route": "cuda", "source": FUSED_T1_SRC,
        "replaces": FUSED_T1_TPU, "launches": totals["launches"],
        "max_abs_err": worst, "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "matches_plain": worst == 0}]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
