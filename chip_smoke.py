#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bucketeer_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds, is right and runs
its two Tier-1 paths, its read path and its tensor codec on the card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit (nvidia-smi);
2. the build of every library the paths use, one compiler process per
   source, all at once: the kernels csrc/fused_t1.cu, cxd_scan.cu,
   mq_scan.cu and probe.cu (nvcc, with ptxas's register and spill lines
   and each Tier-1 kernel's resident thread blocks per SM printed) and
   the host Tier-1 csrc/host_t1.cpp (g++); then the capability check
   (kernels/support.py require_kernels);
3. each kernel against its plain PyTorch version on the same inputs,
   one plain run per launch group held against three kernels: fused_t1,
   cxd_scan, and mq_scan fed cxd_scan's own symbols. Synthetic launch
   groups at L in {8, 16, 32}, frac in {0, 7}, every band class,
   partial, all-zero and floored-dead blocks, each 64x64 at most (plain
   side on the host CPU, in worker processes), the deep group (L=32,
   dense blocks at nbp 31 and 30, 1x64 and 64x1 blocks; plain side on
   the card), then the largest launch group of the full-size image's
   first lossless chunk (plain side on the card), with each kernel's
   time, its bound, the serial chain of its longest block, the launch's
   multiple of that chain and the kernel's residency; mq_scan against
   its plain version (on the host) on the MQ stress streams
   (mq_stress_streams: totals at the kernel's staging chunk,
   single-context runs, carries into 0xFF, duplicate and out-of-range
   pass counts, empty streams, more bytes than the capacity), at their
   own stride and padded to 16 bytes; then the probe against x + 1 by
   device time;
4. slice parity: a 256x256 RGB image through the Kakadu recipe, both
   conversions, encode_jp2 on the card byte-identical to encode_jp2 on
   the CPU (where every kernel runs its plain version), for the fused
   path and for the CX/D split;
5. the main paths: a 4096x4096 8-bit RGB TIFF (BASELINE config 1's
   size) made from --seed through CudaConverter().convert (the fused
   device Tier-1) and CudaConverter(device_cxd=True,
   device_mq=False).convert (the CX/D split: device scan, host MQ
   replay), lossless and lossy, each after one warm-up and with every
   launch count set to 0 just before it and read just after: wall time,
   MPix/s, kernel launches and time (CUDA events around each C launch),
   bounds, Tier-1 volume, the split's host stages, peak device memory;
   the split's files must equal the fused path's byte for byte. Then one synchronized convert of each
   kind per path, timed stage by stage; the fused lossy run hands its
   largest L=8 and L=16 launch groups (frac 7, the rate estimator's
   floors) to a second kernel-against-plain check on the card, which
   also holds mq_scan(cxd_scan(x)) against fused_t1(x) and times them
   as phase 3 times the lossless group;
6. the read path on phase 5's fused derivatives, through
   CudaReader(device="cuda").read with a metrics sink, the launch counts
   set to 0 just before and read just after (the read path runs no
   Tier-1 kernel): a full-resolution tile (1024, 1536, 512, 512), a
   window over four tiles (lossless) or nine (lossy) and a thumbnail
   (reduce=4 lossless, reduce=3 lossy), each cold and then warm (one
   tile-cache hit returning the same array), with its decode stages,
   MQ decisions, code-blocks, the device inverse by CUDA events and the
   output's size; then the lossless reads equal the source crop (the
   thumbnail: the CPU decode of the same bytes) exactly, the lossy tile
   equals the crop of a read of (1000, 1500, 600, 600) exactly and is
   within +-1 of the same read on the CPU, as the lossy thumbnail is
   (differing samples counted), the lossy tile's PSNR against the
   source, one stream index per file, and the device's busy time inside
   the inverse of two reads by torch.profiler;
7. tensors and coefficients: (a) three 4096x4096 tensors made from
   --seed on the card (int8 N(0, 2) clipped to +-7, and one N(0, 1) *
   0.02 weight matrix in bfloat16 and in float32) through encode_tensor:
   the device backend (the fused kernel) at the default 64-block chunk
   and at chunk_blocks=4096, the replay backend (cxd_scan, host MQ
   replay) once, each with the launch counts set to 0 just before and
   read just after, wall time, MB/s, coded bytes, each launch by CUDA
   events beside its bound, symbols, peak device memory; the three
   blobs identical; (b) the oracle on each tensor's first 16 blocks per
   limb: the card's blob of that slice (the warm-up) equals the full
   blob's blocks, the host reference coder's blob and decodes to the
   slice bit for bit; (c) coefficient reads of phase 5's derivatives
   through CudaReader(device="cuda").read_coefficients (full reduce=4
   lossless / reduce=3 lossy, the one-tile region at reduce 0 and at
   those reduces), each cold then warm twice (a hit is a set of its
   own, equal band for band and sharing no storage), with decode
   stages, MQ decisions, the dequantizer by CUDA events and the cold
   time beside phase 6's pixel read of the same window; region reads
   equal the crop of the full read, every band is on the card and
   equals the same read on the CPU. The oracle's host coder and the CPU reads run in worker
   processes after every timed card run;
8. the cross-request scheduler: one EncodeScheduler(device="cuda") with
   a Metrics sink, the launch counts set to 0 just before and read just
   after, launching from threads that never set a CUDA device: four
   concurrent CudaConverter(scheduler=...).convert calls (lossless and
   lossy, of phase 5's image and a second 4096x4096 image from --seed +
   1), then two concurrent split converts on the shared host Tier-1
   pool, each file equal to the direct encode of its image (phase 5's
   files; the second image's own encode_jp2 without a scheduler), with
   the concurrent wall beside the solo walls, queue waits and peak
   device memory; with one slot and an encode running, a queued encode
   and then a 512x512 lossy tile read through CudaReader(scheduler=...):
   the read is granted first and equals phase 6's read; phase 7's
   bfloat16 tensor and three more from --seed + 2 through submit_tensor
   from four threads, blobs equal to the direct encodes, with merged
   launches (tensor.batch_occupancy max > 1) timed by CUDA events
   beside their bound; two concurrent coefficient-read misses and a
   two-item batch read (merged dequantizer), bands equal to phase 7's;
   admission on a scheduler of its own: QueueFull with retry_after,
   DeadlineExceeded, and close() failing the queued waiter with
   SchedulerClosed without a hang;
9. the service on the card, below HTTP (the card's machine has no
   aiohttp): an Engine(device="cuda") with a fake S3 bucket and a
   recording Slack client, in one asyncio loop, the launch counts set to
   0 before each part and read after: single-image requests on the bus
   (IMAGE_WORKER, lossless and lossy of phase 5's TIFF, and a missing
   file, which must fail), each object in the bucket equal to phase 5's
   fused file and each request's fused_t1 launches equal to phase 5's; a
   4-item CSV job (phase 5's and phase 8's images, twice each) through
   job_factory and start_job on a journaled store, every item succeeded
   with its IIIF URL, every object equal to its direct encode, a Slack
   message naming the job, and the journal replaying to the finished
   job; a 2-item job on a second Engine configured for the CX/D split,
   objects equal to the fused files;
10. the host Tier-1 on the card (front-end mode "rows": bit-planes
   packed on the card, the planes each block codes gathered to the host
   and coded there in C++), the launch counts set to 0 before and read
   after (the path runs no kernel): (a) phase 5's image through
   CudaConverter(device_mq=False, device_cxd=False), lossless and lossy,
   each file equal to phase 5's fused file, with the wall, the payload
   fetched, then a synchronized breakdown (front-end, packing, payload
   plan and fetch, the host coder on the shared pool, PCRD + Tier-2) and
   peak device memory; (b) the same image lossless at tile 320, 5 levels
   (sub-bands straddle the 64x64 code-block grid, so the blocks are
   sliced and coded on the host), equal to the same encode with
   device="cpu" and decoded on the card (codec.decode.decode, tile-
   aligned strips in worker processes) to the source exactly; (c) two
   concurrent lossless rows converts of phase 5's and phase 8's images
   through one scheduler, each equal to its solo run, with fewer
   front-end launches (merged) than the solo runs' sum;
11. the mesh and the batch data plane on the card: (a) phase 5's image
   as one tile, lossless, 6 levels, on a 1x4 mesh of the card repeated
   (row shards, DWT halo copies between them, the host block coder): the
   file equals the single-device encode, with the wall, the sharded
   transform by CUDA events, the halo bytes, a synchronized breakdown
   and peak device memory; then the lossy transform (9/7 + ICT) on the
   mesh against run_tiles, max |delta| <= 1 index on < 1 % of samples;
   (b) an 8192x8192 TIFF from --seed + 3 (the least square at or above
   the converter's mesh threshold), Kakadu recipe, lossless, on a 4x1
   mesh of the card repeated: the file equals CudaConverter().convert's,
   which does not route on one card (with two cards or more, the
   converter's routed file across them too); (c) a batch read through
   the process-wide scheduler, the launch counts set to 0 before and
   read after: phase 5's and phase 8's lossless derivatives, a copy of
   the first and a truncated copy at reduce 4: exactly one failed item,
   the bands equal the per-image coefficient reads and lie on the card,
   the merged dequantizer launches printed; encode_batch launches
   fused_t1 (timed by CUDA events beside its bound) and round-trips
   through decode_batch exactly, and truncate_batch equals a floored
   encode_batch after decode;
12. the defaults and the analysis, the launch counts set to 0 before
   each encode and read after: (a) encode_jp2 of a 512x512 corner of
   phase 5's image (Kakadu recipe, lossless) with default parameters on
   the card launches fused_t1 and gives the bytes of device_mq=True; on
   the CPU the defaults take the host Tier-1 (no kernel wrapper called)
   and give the same lossless bytes; (b) two requests through one
   EncodeScheduler(device="cuda") call dispatch_frontend with its
   default mode, and their tiles go to the card in one merged launch
   whose windows equal solo launches; (c) python -m
   bucketeer_tpu_torch.analysis --strict --race (8 interleavings per
   default scenario) in a process of its own: lint clean, and no race,
   lock cycle, deadlock, broken invariant or divergence;
13. one JSON line with every kernel, then the card line and the result
   line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit peak
CSRC = "bucketeer_tpu_torch/csrc/"
TPU = "bucketeer_tpu/codec/pallas/"
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


# --- phase 3: kernels against plain -----------------------------------

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


DEEP_PLANES = 8     # coded planes of the deep group's blocks


def deep_group(rng, planes: int = DEEP_PLANES):
    """The deep corner at L=32: two dense blocks (about half the samples
    significant) at nbp 31 and 30 over full 64-row extents, so stripes
    reach row 63 and the widest shifts run, and a 1x64 and a 64x1 block.
    The floors leave ``planes`` coded planes per block, the top ones:
    the plain side's time grows with the depth."""
    hw = [(64, 64), (64, 48), (1, 64), (64, 1)]
    nbp = [31, 30, 31, 30]
    n = len(hw)
    blocks = np.zeros((n, 64, 64), np.int64)
    for i, ((h, w), p) in enumerate(zip(hw, nbp)):
        mags = (rng.random((h, w)) < 0.5) * rng.integers(
            1, 1 << p, size=(h, w), dtype=np.int64)
        mags[0, 0] = (1 << p) - 1
        blocks[i, :h, :w] = mags * np.where(rng.random((h, w)) < 0.5,
                                            -1, 1)
    nbps = np.array(nbp, np.int32)
    floors = np.maximum(nbps - planes, 0).astype(np.int32)
    cls = np.array([0, 1, 2, 1], np.int32)
    hs = np.array([h for h, _ in hw], np.int32)
    ws = np.array([w for _, w in hw], np.int32)
    return [torch.as_tensor(a) for a in (blocks.astype(np.int32), nbps,
                                         floors, cls, hs, ws)]


def _masked_err(got, ref, lo: int, hi) -> float:
    """Max |got - ref| over columns [lo, hi[b]) of each row b (bytes
    outside that window carry no meaning)."""
    if not got.numel():
        return 0.0
    cols = torch.arange(got.shape[1], device=got.device)
    mask = (cols[None, :] >= lo) & (cols[None, :] < hi.to(cols.dtype)[:, None])
    diff = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    return float(torch.where(mask, diff, 0).max())


def _err(got, ref) -> float:
    if not got.numel():
        return 0.0
    return float((got.to(torch.float64) - ref.to(torch.float64)).abs().max())


def _bits_err(got, ref) -> float:
    """0 when two float32 tensors agree bit for bit, signed zeros
    included; else 1."""
    return 0.0 if torch.equal(got.view(torch.int32),
                              ref.view(torch.int32)) else 1.0


def compare_fused(L: int, got, ref) -> float:
    """fused_t1's seven outputs, exactly: bytes inside each block's data
    window, the distortion pairs bit for bit."""
    from bucketeer_tpu_torch.kernels import fused_t1 as ft

    n = ref[1].shape[0]
    cap = ft.mq_capacity(ft.max_syms(L))
    err = _masked_err(got[0].reshape(n, cap), ref[0].reshape(n, cap), 1,
                      ref[2] + 1)
    err = max([err] + [_err(got[k], ref[k]) for k in (1, 2, 3, 4, 5, 6)])
    return max(err, _bits_err(got[3], ref[3]), _bits_err(got[4], ref[4]))


def compare_scan(got, ref) -> float:
    """cxd_scan's outputs: symbols over each block's [0, cur), counts and
    cursors exactly, the distortion pairs bit for bit."""
    err = _masked_err(got[0], ref[0], 0, ref[4])
    err = max(err, _err(got[1], ref[1]), _err(got[4], ref[4]))
    return max(err, _bits_err(got[2], ref[2]), _bits_err(got[3], ref[3]))


def compare_mq(got, ref) -> float:
    """mq_scan's outputs: bytes over each block's [1, 1 + dlen), snaps,
    data lengths and byte cursors exactly."""
    err = _masked_err(got[0], ref[0], 1, ref[2] + 1)
    return max([err] + [_err(got[k], ref[k]) for k in (1, 2, 3)])


def flags_of(args):
    return (args[1] > args[2]).to(torch.int32)


def mq_budget(L: int) -> tuple:
    """(n_steps, byte capacity) for mq_scan over an L-plane scan's
    symbol rows: the rows' full length, as the fused kernel's coder
    has."""
    from bucketeer_tpu_torch.kernels import cxd_scan as cs, mq_scan as ms

    msym = cs.max_syms(L)
    return msym, ms.mq_capacity(msym)


MQ_STRESS_L = 4
MQ_STRESS_STEPS = 1032           # a row's symbols; 1032 % 16 == 8
MQ_CARRY_SEEDS = (95, 259, 293)  # 1,025 uniform-context decisions each,
                                 # coded with a carry into a 0xFF byte
                                 # and bits stuffed after 0xFF


def _mq_rows(rng, n: int, ctxs: int = 19, p_one: float = 0.5):
    """n random symbol rows ``ctx | d << 5``: contexts uniform below
    ``ctxs``, decisions 1 with probability ``p_one``."""
    cx = rng.integers(0, ctxs, (n, MQ_STRESS_STEPS))
    d = (rng.random((n, MQ_STRESS_STEPS)) < p_one).astype(np.int64)
    return (cx | d << 5).astype(np.uint8)


def _mq_kind(rng, rows, totals, flags=None, counts=None, cap=512):
    """One stress kind's mq_scan arguments; pass counts drawn sorted in
    [0, total] unless given, every stream flushed unless flags say."""
    totals = np.asarray(totals, np.int32)
    if counts is None:
        counts = np.stack([
            np.sort(rng.integers(0, t + 1, MQ_STRESS_L * 3))
            for t in totals]).reshape(-1, MQ_STRESS_L, 3)
    flags = np.ones(len(totals)) if flags is None else flags
    return (MQ_STRESS_L, MQ_STRESS_STEPS, cap, rows,
            np.asarray(counts, np.int32), totals, np.asarray(flags, np.int32))


def mq_stress_streams(seed: int = 7) -> dict:
    """MQ symbol streams made to stress the MQ coder kernel's design, by
    kind: {kind: (L, n_steps, cap, syms, counts, totals, flags)} as numpy
    arrays, all at plane budget MQ_STRESS_L with rows of MQ_STRESS_STEPS
    symbols (not a multiple of 16, so every second row starts off a
    16-byte boundary).

    - chunk: totals of the kernel's staging chunk (kernels/mq_scan.py
      MQ_CHUNK) and twice it, one less and one more, each on an aligned
      and an unaligned row;
    - one context: runs of a single context (rare LPS; LPS-heavy, so the
      state changes between neighbours; alternating decisions; runs of
      64), which exercise the forwarded state word;
    - carry: the uniform context with random decisions, seeds
      MQ_CARRY_SEEDS, whose coding carries into a 0xFF byte and stuffs
      bits after 0xFF;
    - counts: duplicate pass counts, 0, 1, the total, past the total and
      negative;
    - empty: totals 0 (flag 0 and 1), 1, 2 and 3, and a stream not
      flushed;
    - overflow: more coded bytes than cap, which the wrapper admits (its
      caller checks the byte cursor)."""
    from bucketeer_tpu_torch.kernels.mq_scan import MQ_CHUNK

    rng = np.random.default_rng(seed)
    n = MQ_STRESS_STEPS
    ch = MQ_CHUNK
    out = {}
    totals = np.repeat([ch - 1, ch, ch + 1, 2 * ch - 1, 2 * ch, 2 * ch + 1],
                       2)
    out["chunk"] = _mq_kind(rng, _mq_rows(rng, len(totals), p_one=0.3),
                            totals)
    rows = np.empty((5, n), np.uint8)
    rows[0] = (rng.random(n) < 0.02).astype(np.uint8) << 5
    rows[1] = 17 | rng.integers(0, 2, n).astype(np.uint8) << 5
    rows[2] = 18 | (np.arange(n) % 2).astype(np.uint8) << 5
    runs = np.repeat(rng.integers(0, 19, n // 64 + 1), 64)[:n]
    rows[3] = runs | (rng.random(n) < 0.2).astype(np.int64) << 5
    rows[4] = 5 | 1 << 5
    out["one context"] = _mq_kind(rng, rows, [n] * 5)
    rows = np.zeros((len(MQ_CARRY_SEEDS), n), np.uint8)
    for i, s in enumerate(MQ_CARRY_SEEDS):
        rows[i, :2 * ch + 1] = 18 | np.random.default_rng(s).integers(
            0, 2, 2 * ch + 1).astype(np.uint8) << 5
    out["carry"] = _mq_kind(rng, rows, [2 * ch + 1] * len(rows))
    counts = [[0, 0, 1, 1, 250, 250, 250, 500, 500, 501, 10 ** 6, -3],
              [500, 500, 500, 500, 7, 7, 7, 7, 499, 0, 0, 500],
              [3, 2, 1, 250, 251, 250, 2, 3, 0, 1, 249, 250],
              [1, 1, 1, 0, 0, 0, 2, 2, 2, 1, -1, 1]]
    out["counts"] = _mq_kind(rng, _mq_rows(rng, 4), [500, 500, 250, 1],
                             counts=np.reshape(counts, (4, MQ_STRESS_L, 3)))
    out["empty"] = _mq_kind(rng, _mq_rows(rng, 6), [0, 0, 1, 2, 3, 700],
                            flags=[0, 1, 1, 1, 1, 0])
    out["overflow"] = _mq_kind(rng, _mq_rows(rng, 3), [n, 1000, 2 * ch + 1],
                               cap=64)
    return out


def as_fused(scan, mq):
    """The fused kernel's output tuple from a CX/D scan and the MQ coder
    run over its symbols (the plain fused version is this composition)."""
    from bucketeer_tpu_torch.kernels import fused_t1 as ft

    return (mq[0].reshape(-1, ft.MQ_ROW_BYTES), mq[1], mq[2], scan[2],
            scan[3], scan[4], mq[3])


def run_plain(L: int, frac: int, args) -> tuple:
    """One plain run of a launch group on its tensors' device: the plain
    CX/D scan, then the plain MQ coder over its symbols. Returns (scan,
    mq, scan seconds, mq seconds)."""
    from bucketeer_tpu_torch.kernels import cxd_scan as cs, mq_scan as ms

    sync = (torch.cuda.synchronize if args[0].is_cuda else lambda: None)
    t0 = time.perf_counter()
    scan = cs.cxd_scan_plain(L, frac, *args)
    sync()
    t1 = time.perf_counter()
    mq = ms.mq_scan_plain(L, *mq_budget(L), scan[0], scan[1], scan[4],
                          flags_of(args))
    sync()
    return scan, mq, t1 - t0, time.perf_counter() - t1


def run_kernels(L: int, frac: int, args) -> tuple:
    """The three Tier-1 kernels on one launch group: (fused_t1, cxd_scan,
    mq_scan over cxd_scan's symbols)."""
    from bucketeer_tpu_torch.kernels import cxd_scan as cs, fused_t1 as ft
    from bucketeer_tpu_torch.kernels import mq_scan as ms

    fused = ft.fused_t1(L, frac, *args)
    scan = cs.cxd_scan(L, frac, *args)
    mq = ms.mq_scan(L, *mq_budget(L), scan[0], scan[1], scan[4],
                    flags_of(args))
    torch.cuda.synchronize()
    return fused, scan, mq


def _bound(n_bytes: int, n_ops: int) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes)


def _extent_bytes(hs, ws) -> int:
    return int((hs.to(torch.int64) * ws.to(torch.int64)).sum()) * 4


def fused_bound(L: int, hs, ws, dlen, cur) -> tuple:
    """Least time for one fused_t1 launch: each input byte read once (a
    block's h x w extent, not its 64x64 slot, and its 5 meta words) and
    each meaningful output byte written once at HBM rate, against one
    32-bit operation per coded decision at the non-tensor peak. Returns
    (ms, bound kind, bytes)."""
    n = hs.shape[0]
    bytes_in = _extent_bytes(hs, ws) + n * 5 * 4
    bytes_out = (int((dlen.to(torch.int64) + 1).sum()) + n * L * 3 * 4 * 3
                 + n * 3 * 4)
    return _bound(bytes_in + bytes_out, int(cur.to(torch.int64).sum()))


def scan_bound(L: int, hs, ws, cur) -> tuple:
    """The same for one cxd_scan launch: the extents and meta in; one
    byte per symbol, the counts and distortion pairs and the cursor out;
    one operation per decision."""
    n = hs.shape[0]
    syms = int(cur.to(torch.int64).sum())
    return _bound(_extent_bytes(hs, ws) + n * 5 * 4
                  + syms + n * L * 3 * 4 * 3 + n * 4, syms)


def mq_bound(L: int, cur, dlen) -> tuple:
    """The same for one mq_scan launch: one byte per symbol, the counts,
    totals and flags in; the coded bytes, snaps, lengths and cursors
    out; one operation per decision."""
    n = cur.shape[0]
    syms = int(cur.to(torch.int64).sum())
    return _bound(syms + n * L * 3 * 4 + n * 8
                  + int((dlen.to(torch.int64) + 1).sum()) + n * L * 3 * 4
                  + n * 8, syms)


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
    """Times one kernel's launches on a main path: CUDA events recorded
    right before and after the C launch itself (kernels/build.py
    ``launch`` as the wrapper's module calls it, after the capability
    check), so host work around a launch does not count; and, by
    wrapping the wrapper as codec/cxd.py calls it, what ``volume(L,
    args, out)`` keeps of each launch (small tensors only) for its
    bound."""

    def __init__(self, module, fn, volume):
        self.module = module            # the wrapper's module
        self.fn = fn
        self.volume = volume
        self.launches = []              # (start, stop, volume)
        self._events = None
        self._real = None

    def __call__(self, L, frac, *args):
        self._events = None
        out = self.fn(L, frac, *args)
        if self._events is not None:
            self.launches.append(self._events + (self.volume(L, args, out),))
        return out

    def __enter__(self):
        from bucketeer_tpu_torch.kernels.support import require_kernels

        real = self._real = self.module.launch

        def timed(kernel, fn_args, device):
            require_kernels(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            real(kernel, fn_args, device)
            stop.record()
            self._events = (start, stop)

        self.module.launch = timed
        return self

    def __exit__(self, *exc):
        self.module.launch = self._real

    def kernel_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e, _ in self.launches)

    def bounds(self, bound) -> list:
        return [bound(*v) for _, _, v in self.launches]


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
    functions the encoder calls. With ``sync`` each wrapper synchronizes
    the card on entry and exit, so device work lands in the stage that
    queued it (and chunks no longer overlap — that pass is for the
    breakdown, not for throughput); without it a stage is only its host
    time."""

    def __init__(self, stages, sync: bool = True):
        self.stages = stages            # [(label, module, attribute)]
        self.sync = sync
        self.seconds = {label: 0.0 for label, _, _ in stages}
        self.calls = {label: 0 for label, _, _ in stages}
        self._saved = []

    def _wrap(self, label, fn):
        def timed(*a, **kw):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if self.sync:
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

    def line(self) -> str:
        return ", ".join(f"{k} {v:.3f} ({self.calls[k]}x)"
                         for k, v in self.seconds.items())


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
    fres = frontend.dispatch_frontend(plan, batch, mode="mq",
                                      device="cuda").resolve_stats()
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


def libraries() -> dict:
    from bucketeer_tpu_torch.codec import t1_batch
    from bucketeer_tpu_torch.kernels import cxd_scan, fused_t1, mq_scan
    from bucketeer_tpu_torch.kernels import support

    return {"fused_t1": fused_t1.KERNEL, "cxd_scan": cxd_scan.KERNEL,
            "mq_scan": mq_scan.KERNEL, "probe": support.PROBE,
            "host_t1": t1_batch.HOST_T1}


def phase_build() -> None:
    from bucketeer_tpu_torch.kernels.support import require_kernels

    libs = libraries()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        paths = dict(zip(libs, pool.map(lambda lib: lib.build(),
                                        libs.values())))
    say(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s "
        "wall, one compiler process each, all at once")
    for name, lib in libs.items():
        lib.library()
        say(f"build: {name} ({'nvcc' if lib.cuda else 'g++'} "
            f"{lib.build_seconds:.2f} s) -> {os.path.relpath(paths[name])}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"build: {name} ptxas: {line.strip()}")
        if name in ("fused_t1", "cxd_scan", "mq_scan"):
            from bucketeer_tpu_torch.kernels.build import resident_blocks

            say(f"build: {name} resident thread blocks (= code-blocks) per "
                "SM at L 8 / 16 / 32: " + " / ".join(
                    str(resident_blocks(lib, L)) for L in (8, 16, 32)))
    require_kernels("cuda")
    say("build: require_kernels(cuda) passed (probe x + 1 exact)")


def plain_on_host(job) -> tuple:
    """One plain run of a launch group on the host CPU, in a worker
    process (one thread): (L, frac, numpy arrays) in, (scan, MQ) outputs
    as numpy arrays and both times out."""
    L, frac, arrays = job
    torch.set_num_threads(1)
    scan, mq, t_scan, t_mq = run_plain(
        L, frac, [torch.from_numpy(a) for a in arrays])
    return ([t.numpy() for t in scan], [t.numpy() for t in mq], t_scan,
            t_mq)


def mq_plain_on_host(job) -> tuple:
    """mq_scan_plain over one stress kind on the host CPU, in a worker
    process (one thread): its outputs as numpy arrays, and the time."""
    from bucketeer_tpu_torch.kernels.mq_scan import mq_scan_plain

    L, steps, cap, *arrays = job
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = mq_scan_plain(L, steps, cap, *map(torch.from_numpy, arrays))
    return [t.numpy() for t in out], time.perf_counter() - t0


def check_mq_stress(streams: dict, plains: dict) -> float:
    """mq_scan on the card against mq_scan_plain (run on the host) on
    every stress kind at tolerance 0: at the rows' own stride (every
    second row off a 16-byte boundary) and with the rows padded to 16
    bytes."""
    from bucketeer_tpu_torch.kernels import mq_scan as ms

    worst = 0.0
    for kind, (L, steps, cap, sym, *rest) in streams.items():
        ref, t_plain = plains[kind]
        ref = [torch.from_numpy(r).cuda() for r in ref]
        rest = [torch.from_numpy(a).cuda() for a in rest]
        padded = np.zeros((len(sym), -(-steps // 16) * 16), np.uint8)
        padded[:, :steps] = sym
        errs = []
        for rows in (sym, padded):
            got = ms.mq_scan(L, steps, cap, torch.from_numpy(rows).cuda(),
                             *rest)
            torch.cuda.synchronize()
            errs.append(compare_mq(got, ref))
        totals = rest[1]
        say(f"mq stress: {kind}: {len(sym)} streams of "
            f"{int(totals.min())}-{int(totals.max())} symbols, cap {cap}, "
            f"{int(ref[2].sum())} coded bytes; mq_scan max_abs_err at "
            f"stride {steps} / {padded.shape[1]}: {errs[0]} / {errs[1]} "
            f"(tolerance 0); plain on host {t_plain:.2f} s")
        if max(errs) != 0:
            fail(f"mq_scan differs from its plain version on the {kind} "
                 "stress streams")
        worst = max([worst] + errs)
    return worst


def check_group(label: str, L: int, frac: int, args, plain=None) -> dict:
    """One plain run of a launch group held against the three Tier-1
    kernels at tolerance 0: fused_t1, cxd_scan, and mq_scan over
    cxd_scan's own symbols. ``args`` on the card; the plain side runs on
    the card too, unless ``plain`` holds plain_on_host's result for the
    group. Returns the worst errors per kernel and the outputs."""
    t0 = time.perf_counter()
    fused, scan, mq = run_kernels(L, frac, args)
    t_k = time.perf_counter() - t0
    if plain is None:
        p_scan, p_mq, t_scan, t_mq = run_plain(L, frac, args)
        plain_on = "cuda"
    else:
        p_scan, p_mq, t_scan, t_mq = plain
        plain_on = "cpu"
    dev = args[0].device

    def back(t):
        return [torch.as_tensor(x).to(dev) for x in t]

    p_scan, p_mq = back(p_scan), back(p_mq)
    errs = {"fused_t1": compare_fused(L, fused, as_fused(p_scan, p_mq)),
            "cxd_scan": compare_scan(scan, p_scan),
            "mq_scan": compare_mq(mq, p_mq)}
    where = "on the card" if plain_on == "cuda" else "on host"
    say(f"kernel-vs-plain: {label} L={L} frac={frac} "
        f"blocks={args[0].shape[0]} (floored {int((args[2] > 0).sum())}) "
        f"symbols={int(p_scan[4].sum())} bytes={int(p_mq[2].sum())}: "
        + ", ".join(f"{k} max_abs_err={v}" for k, v in errs.items())
        + f" (tolerance 0); kernels {t_k:.3f} s, plain {where} "
        f"{t_scan:.1f} s scan + {t_mq:.1f} s MQ")
    for name, err in errs.items():
        if err != 0:
            fail(f"{name} differs from its plain version on {label} L={L} "
                 f"frac={frac}")
    return {"errs": errs, "plain_s": (t_scan, t_mq), "fused": fused,
            "scan": scan, "mq": mq}


def check_chain(label: str, L: int, res: dict) -> float:
    """mq_scan(cxd_scan(x)) against fused_t1(x), both kernels."""
    err = compare_fused(L, res["fused"], as_fused(res["scan"], res["mq"]))
    say(f"chain: {label} L={L} mq_scan(cxd_scan(x)) vs fused_t1(x) "
        f"max_abs_err={err} (tolerance 0)")
    if err != 0:
        fail(f"mq_scan(cxd_scan(x)) differs from fused_t1(x) on {label}")
    return err


def time_group(label: str, L: int, frac: int, args, res: dict) -> dict:
    """Each Tier-1 kernel's time on one real launch group by CUDA
    events, its bound, the serial chain (the group's longest block
    launched alone), the launch's multiple of that chain, and how many
    thread blocks and warps of the kernel one SM holds at once (its
    exported occupancy query)."""
    from bucketeer_tpu_torch.kernels import cxd_scan as cs, fused_t1 as ft
    from bucketeer_tpu_torch.kernels import mq_scan as ms
    from bucketeer_tpu_torch.kernels.build import resident_blocks

    fused, scan, mq = res["fused"], res["scan"], res["mq"]
    flags = flags_of(args)
    mq_in = (scan[0], scan[1], scan[4], flags)
    cap = mq_budget(L)[1]
    ms_of = {
        "fused_t1": time_kernel(lambda: ft.fused_t1(L, frac, *args)),
        "cxd_scan": time_kernel(lambda: cs.cxd_scan(L, frac, *args)),
        # The C launch alone: the wrapper's checks wait for the card.
        "mq_scan": time_kernel(lambda: ms.launch_mq(L, cap, *mq_in, mq)),
    }
    bound_of = {
        "fused_t1": fused_bound(L, args[4], args[5], fused[2], fused[5]),
        "cxd_scan": scan_bound(L, args[4], args[5], scan[4]),
        "mq_scan": mq_bound(L, scan[4], mq[2]),
    }
    b = int(torch.argmax(scan[4]))
    one = [a[b:b + 1].contiguous() for a in args]
    mq_one = [a[b:b + 1].contiguous() for a in mq_in]
    mq_out = ms.mq_scan(L, *mq_budget(L), *mq_one)
    chain = {"fused_t1": time_kernel(lambda: ft.fused_t1(L, frac, *one)),
             "cxd_scan": time_kernel(lambda: cs.cxd_scan(L, frac, *one)),
             "mq_scan": time_kernel(
                 lambda: ms.launch_mq(L, cap, *mq_one, mq_out))}
    t_scan, t_mq = res["plain_s"]
    plain_ms = {"fused_t1": (t_scan + t_mq) * 1e3, "cxd_scan": t_scan * 1e3,
                "mq_scan": t_mq * 1e3}
    kernels = {"fused_t1": ft.KERNEL, "cxd_scan": cs.KERNEL,
               "mq_scan": ms.KERNEL}
    # One code-block per thread block in all three; warps per thread
    # block: fused_t1's scan warp and coder warp, one in the others.
    warps = {"fused_t1": 2, "cxd_scan": 1, "mq_scan": 1}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = args[0].shape[0]
    n_dec = int(scan[4][b])
    out = {}
    for name in ms_of:
        bound, by, moved = bound_of[name]
        tbs = resident_blocks(kernels[name], L)
        fits = tbs * sms
        say(f"kernel time: {name} {label} L={L} {n} blocks: "
            f"{ms_of[name]:.3f} ms/launch, bound {bound:.6f} ms by {by} "
            f"({moved} B), plain on the card {plain_ms[name]:.0f} ms; "
            f"serial chain (longest block alone, {n_dec} decisions) "
            f"{chain[name]:.3f} ms, "
            f"{chain[name] * 1e6 / max(n_dec, 1):.1f} ns per decision, "
            f"launch/chain {ms_of[name] / chain[name]:.2f}; resident per SM "
            f"{tbs} thread blocks = {tbs * warps[name]} warps ({tbs} "
            f"code-blocks), {fits} on {sms} SMs: {-(-n // fits)} wave(s)")
        out[name] = {"ms": ms_of[name], "plain_ms": plain_ms[name],
                     "bound_ms": bound, "bound_by": by,
                     "chain_ms": chain[name]}
    return out


def phase_kernel_vs_plain(rng, img) -> tuple:
    """The synthetic groups' plain sides run in worker processes on the
    host's cores while the deep group and the image group run theirs on
    the card."""
    worst = {"fused_t1": 0.0, "cxd_scan": 0.0, "mq_scan": 0.0}

    def note(res):
        for k, v in res["errs"].items():
            worst[k] = max(worst[k], v)

    jobs = [(L, frac, synthetic_group(rng, L, frac))
            for L in (8, 16, 32) for frac in (0, 7)]
    deep = [a.cuda() for a in deep_group(rng)]
    streams = mq_stress_streams()
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(jobs), mp_context=spawn) as pool:
        plains = [pool.submit(plain_on_host,
                              (L, frac, [a.numpy() for a in args]))
                  for L, frac, args in jobs]
        mq_plains = {kind: pool.submit(mq_plain_on_host, job)
                     for kind, job in streams.items()}
        # The deep corner.
        note(check_group("synthetic deep (nbp 31/30, 64-row, 1x64, 64x1)",
                         32, 0, deep))
        # One real launch group of the full-size image: the largest of
        # its first lossless chunk.
        groups = first_chunk_groups(img)
        L, _, args = max(groups, key=lambda g: len(g[1]))
        res = check_group("image group (lossless first chunk)", L, 0, args)
        note(res)
        worst["fused_t1"] = max(worst["fused_t1"],
                                check_chain("lossless first chunk", L, res))
        for (Ls, frac, sargs), plain in zip(jobs, plains):
            note(check_group("synthetic", Ls, frac,
                             [a.cuda() for a in sargs], plain.result()))
        worst["mq_scan"] = max(worst["mq_scan"], check_mq_stress(
            streams, {k: f.result() for k, f in mq_plains.items()}))
    return worst, time_group("lossless", L, 0, args, res)


def device_kernel_ms(fn, reps: int = 1000) -> tuple:
    """Device time per kernel of ``fn`` (one kernel per call) over
    ``reps`` calls: the mean of the kernel durations torch.profiler
    records (it may drop some of them); where it records none, CUDA
    events around the ``reps`` calls (then the host's enqueue rate
    bounds it from above). Returns (ms, source)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.device_time > 0]
    if times:
        return (sum(times) / len(times) / 1e3,
                f"profiler kernel durations, {len(times)} kernels")
    return time_kernel(fn, reps), "CUDA events"


def phase_probe() -> dict:
    """The capability probe against its plain version, x + 1, which is
    also the one PyTorch call that computes the same function; each
    timed by its device time over 1,000 launches."""
    from bucketeer_tpu_torch.kernels import support

    x = torch.arange(8, dtype=torch.int32, device="cuda")
    err = _err(support.probe(x), x + 1)
    ms, how = device_kernel_ms(lambda: support.probe(x))
    plain_ms, plain_how = device_kernel_ms(lambda: x + 1)
    enqueue_ms = time_kernel(lambda: support.probe(x), 1000)
    bound, by, moved = _bound(2 * x.numel() * 4, x.numel())
    say(f"kernel-vs-plain: probe (8,) int32 max_abs_err={err} (tolerance "
        f"0); {ms:.5f} ms/launch ({how}), x + 1 {plain_ms:.5f} ms "
        f"({plain_how}), 1,000 probe launches by CUDA events "
        f"{enqueue_ms:.5f} ms each, bound {bound:.9f} ms by {by} "
        f"({moved} B)")
    if err != 0:
        fail("the probe kernel differs from x + 1")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": plain_ms}


def phase_parity(rng) -> None:
    from bucketeer_tpu_torch.codec.encoder import EncodeParams, encode_jp2

    img = photo(rng, 256, 256)
    for lossless in (True, False):
        params = EncodeParams.kakadu_recipe(lossless=lossless)
        params.tile_size = None
        t0 = time.perf_counter()
        on_card = encode_jp2(img, 8, params, jpx=True, device="cuda")
        t_card = time.perf_counter() - t0
        params.device_mq, params.device_cxd = False, True
        t0 = time.perf_counter()
        split = encode_jp2(img, 8, params, jpx=True, device="cuda")
        t_split = time.perf_counter() - t0
        # The fused Tier-1's plain versions on the CPU (its default there
        # is the host Tier-1; phase 12 holds that to the card's bytes).
        params.device_mq, params.device_cxd = True, None
        t0 = time.perf_counter()
        on_cpu = encode_jp2(img, 8, params, jpx=True, device="cpu")
        t_cpu = time.perf_counter() - t0
        kind = "lossless" if lossless else "lossy"
        say(f"parity 256x256 {kind}: card fused {len(on_card)} B in "
            f"{t_card:.2f} s, card split {len(split)} B in {t_split:.2f} "
            f"s, cpu {len(on_cpu)} B in {t_cpu:.1f} s, identical="
            f"{on_card == on_cpu == split}")
        if on_card != on_cpu:
            fail(f"256x256 {kind}: card bytes differ from CPU bytes")
        if split != on_cpu:
            fail(f"256x256 {kind}: the split's card bytes differ from the "
                 "CPU bytes")


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


RUN_LAUNCHES: dict = {}     # launches before the last reset, per library


def reset_counts() -> None:
    """Every kernel's launch count to 0, and the capability probe to
    unprobed, so a path's run shows each launch it makes."""
    from bucketeer_tpu_torch.kernels import support

    for name, lib in libraries().items():
        RUN_LAUNCHES[name] = RUN_LAUNCHES.get(name, 0) + lib.launches
        lib.launches = 0
    support.reset_probe()


def read_counts() -> dict:
    return {name: lib.launches for name, lib in libraries().items()
            if lib.cuda}


def _fused_volume(L, args, out):
    return (L, args[4], args[5], out[2], out[5])


def _scan_volume(L, args, out):
    return (L, args[4], args[5], out[4])


def main_path(conv, src: str, img, split: bool) -> dict:
    """Lossless then lossy through one converter, counts set to 0 just
    before and read just after."""
    from bucketeer_tpu_torch.codec import cxd, t1_batch
    from bucketeer_tpu_torch.converters import Conversion
    from bucketeer_tpu_torch.kernels import cxd_scan, fused_t1

    h, w = img.shape[:2]
    path = "split" if split else "fused"
    kernel = "cxd_scan" if split else "fused_t1"
    real = getattr(cxd, kernel)
    files, walls, per_conv = {}, {}, {}
    reset_counts()
    for conversion in (Conversion.LOSSLESS, Conversion.LOSSY):
        before = read_counts()[kernel]
        timer = LaunchTimer(cxd_scan if split else fused_t1, real,
                            _scan_volume if split else _fused_volume)
        setattr(cxd, kernel, timer)
        host = StageTimer([("pass tables", cxd, "pass_tables"),
                           ("row fetch", cxd, "_fetch_block_rows"),
                           ("host replay", t1_batch, "encode_cxd")],
                          sync=False)
        fetched = [0]
        real_fetch = cxd._fetch_block_rows

        def counting_fetch(*a):
            out = real_fetch(*a)
            fetched[0] += out[0].nbytes
            return out

        cxd._fetch_block_rows = counting_fetch
        torch.cuda.reset_peak_memory_stats()
        try:
            with host, timer:
                t0 = time.perf_counter()
                out = conv.convert(f"smoke-{path}-{conversion.value}", src,
                                   conversion)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            setattr(cxd, kernel, real)
            cxd._fetch_block_rows = real_fetch
        kms = timer.kernel_ms()
        n = len(timer.launches)
        per_conv[conversion] = read_counts()[kernel] - before
        bounds = timer.bounds(scan_bound if split else fused_bound)
        big = max(range(n), key=lambda i: timer.launches[i][2][1].shape[0])
        st = conv.last_stats
        with open(out, "rb") as fh:
            files[conversion] = fh.read()
        walls[conversion] = wall
        data = files[conversion]
        verdict = ("" if split else "; " + check_jp2(
            data, img, conversion == Conversion.LOSSLESS))
        line = (f"main {path} {conversion.value} {w}x{h}: wall {wall:.3f} s, "
                f"{h * w / wall / 1e6:.3f} MPix/s, {len(data)} B "
                f"({len(data) * 8 / (h * w):.3f} bpp); {kernel} launches "
                f"{n}, kernel {kms:.3f} ms total, {kms / max(n, 1):.3f} "
                f"ms/launch (CUDA events around each C launch), bound "
                f"{sum(b[0] for b in bounds):.4f} ms "
                f"(largest group: {timer.launches[big][2][1].shape[0]} "
                f"blocks, bound {bounds[big][0]:.6f} ms by {bounds[big][1]}"
                f", {bounds[big][2]} B); blocks {st['blocks']}, symbols "
                f"{st['symbols']}, bytes {st['bytes']}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if split:
            line += (f"; packed symbol bytes fetched {fetched[0]}; host: "
                     f"{host.line()}, replay threads "
                     f"{t1_batch.default_threads()}")
        say(line + verdict)
        if n <= 0:
            fail(f"{path} {conversion.value}: the path launched {kernel} "
                 "no time")
    counts = read_counts()
    say(f"main {path}: launches in this path's run {counts}")
    want = {"fused_t1": not split, "cxd_scan": split, "mq_scan": False,
            "probe": True}
    for name, launched in want.items():
        if (counts[name] > 0) != launched:
            fail(f"main {path}: {name} launched {counts[name]} times")
    return {"files": files, "walls": walls, "counts": counts,
            "per_conversion": per_conv}


def phase_main(img, workdir) -> dict:
    from bucketeer_tpu_torch.converters import Conversion, CudaConverter

    src = os.path.join(workdir, "smoke.tif")
    write_tiff(src, img)
    convs = {"fused": CudaConverter(),
             "split": CudaConverter(device_cxd=True, device_mq=False)}
    runs = {}
    for path, conv in convs.items():
        t0 = time.perf_counter()
        conv.convert(f"smoke-{path}-warmup", src, Conversion.LOSSLESS)
        torch.cuda.synchronize()
        say(f"main {path}: warm-up lossless convert "
            f"{time.perf_counter() - t0:.2f} s")
        runs[path] = main_path(conv, src, img, path == "split")
    for conversion in (Conversion.LOSSLESS, Conversion.LOSSY):
        same = runs["split"]["files"][conversion] == \
            runs["fused"]["files"][conversion]
        say(f"main {conversion.value}: split file identical to the fused "
            f"file: {same}")
        if not same:
            fail(f"{conversion.value}: the split's file differs from the "
                 "fused path's")
    groups = phase_breakdown(convs["fused"], src, split=False)
    phase_breakdown(convs["split"], src, split=True)
    return {"counts": {p: r["counts"] for p, r in runs.items()},
            "src": src, "files": runs["fused"]["files"],
            "walls": runs["fused"]["walls"],
            "launches": runs["fused"]["per_conversion"],
            "split_walls": runs["split"]["walls"],
            "lossy_groups": groups}


def phase_breakdown(conv, src: str, split: bool):
    """One more convert of each kind with every stage synchronized and
    timed: where an encode's wall time goes. The fused run returns the
    lossy convert's largest launch group at each plane budget, {L:
    (frac, kernel args)}. In the split the host replay runs on its
    worker beside the main thread, so it is listed apart and left out of
    "other"."""
    from bucketeer_tpu_torch.codec import cxd, encoder, frontend, rate
    from bucketeer_tpu_torch.codec import t1_batch, tiff
    from bucketeer_tpu_torch.converters import Conversion

    head = [("tiff read", tiff, "read_image"),
            ("mct choice", encoder, "_mct_helps"),
            ("front-end", frontend, "dispatch_frontend"),
            ("floor estimate", rate, "estimate_floors")]
    tail = [("pcrd + tier-2", encoder, "_finish")]
    if split:
        stages = head + [("tier-1 (cxd_scan kernel)", cxd, "cxd_scan"),
                         ("tier-1 (pack6)", cxd, "pack6"),
                         ("tier-1 (pass tables)", cxd, "pass_tables"),
                         ("tier-1 (fetch)", cxd, "_fetch_block_rows")] + tail
        worker = [("tier-1 (host replay)", t1_batch, "encode_cxd"),
                  ("distortion rescale", encoder, "_correct_distortions")]
    else:
        stages = head + [("tier-1 (kernel)", cxd, "fused_t1"),
                         ("tier-1 (fetch)", cxd, "_fetch_block_rows"),
                         ("tier-1 (assembly)", cxd, "assemble_mq_blocks"),
                         ("distortion rescale", encoder,
                          "_correct_distortions")] + tail
        worker = []
    real = cxd.fused_t1
    capture = None
    for conversion in (Conversion.LOSSLESS, Conversion.LOSSY):
        if not split:
            capture = cxd.fused_t1 = GroupCapture(real)
        try:
            with StageTimer(stages) as st, StageTimer(worker) as wt:
                t0 = time.perf_counter()
                conv.convert(f"smoke-breakdown-{conversion.value}", src,
                             conversion)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            cxd.fused_t1 = real
        rest = wall - sum(st.seconds.values())
        say(f"breakdown {'split' if split else 'fused'} {conversion.value} "
            f"(synchronized): wall {wall:.3f} s = {st.line()}, other "
            f"{rest:.3f} s"
            + (f"; on the replay worker: {wt.line()}" if worker else ""))
    if split:
        return None
    if not {8, 16} <= set(capture.groups):
        fail(f"the lossy convert launched groups at L in "
             f"{sorted(capture.groups)}, not at both 8 and 16")
    return capture.groups


# --- phase 6: the read path ---------------------------------------------

class ReadSink:
    """The decoder's and the reader's metrics sink: seconds and items
    per stage, and counters, summed since the last ``take``."""

    def __init__(self):
        self.stages: dict = {}
        self.counters: dict = {}

    def record(self, stage, seconds, pixels=0, items=0):
        sec, its, n = self.stages.get(stage, (0.0, 0, 0))
        self.stages[stage] = (sec + seconds, its + items, n + 1)

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    def take(self) -> tuple:
        out = (self.stages, self.counters)
        self.stages, self.counters = {}, {}
        return out


class InverseTimer:
    """CUDA events around each call of a device stage, the functions
    ``attrs`` of ``module`` as the read path calls them, summed over the
    calls: the decoder's device inverse (full tiles and region windows,
    from before the host-to-device copy to after the samples'
    ``.cpu()``), or the coefficient dequantizer (from before its copy in
    to the last band's result)."""

    def __init__(self, module, attrs: tuple):
        self.ms = 0.0
        self.calls = 0
        self.module = module
        self.attrs = attrs
        self._saved = []

    def _wrap(self, fn):
        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            stop.record()
            torch.cuda.synchronize()
            self.ms += start.elapsed_time(stop)
            self.calls += 1
            return out
        return timed

    def __enter__(self):
        for attr in self.attrs:
            fn = getattr(self.module, attr)
            self._saved.append((attr, fn))
            setattr(self.module, attr, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for attr, fn in self._saved:
            setattr(self.module, attr, fn)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def _within_one(label: str, got: np.ndarray, ref: np.ndarray) -> int:
    """Fail unless ``got`` is within +-1 of ``ref``; the count of samples
    that differ."""
    if got.shape != ref.shape:
        fail(f"{label}: shape {got.shape} != {ref.shape}")
    diff = np.abs(got.astype(np.int64) - ref)
    n = int((diff > 0).sum())
    say(f"read check: {label}: max |diff| {int(diff.max())} (tolerance 1), "
        f"{n} of {diff.size} samples differ")
    if diff.max() > 1:
        fail(f"{label}: differs by more than 1")
    return n


def _exact(label: str, got: np.ndarray, ref: np.ndarray) -> None:
    same = got.shape == ref.shape and np.array_equal(got, ref)
    say(f"read check: {label}: identical={same} (tolerance 0)")
    if not same:
        fail(f"{label}: not identical")


def phase_read(img) -> dict:
    """IIIF-style reads of the main path's 4096x4096 derivatives through
    CudaReader(device="cuda").read: per read the cold and warm wall
    time, the decode stages, the Tier-1 volume, the device inverse by
    CUDA events and the output's size; then the checks against the
    source, a larger window and the CPU."""
    from bucketeer_tpu_torch.codec.decode import (decode, decoder,
                                                  set_metrics_sink)
    from bucketeer_tpu_torch.converters import CudaReader
    from bucketeer_tpu_torch.converters.reader import derivative_path

    paths = {kind: derivative_path(f"smoke-fused-{kind}")
             for kind in ("lossless", "lossy")}
    if None in paths.values():
        fail(f"the main path's derivatives are missing: {paths}")
    tile = (1024, 1536, 512, 512)                     # x, y, w, h
    reads = [("lossless", "one tile", {"region": tile}),
             ("lossless", "window over four tiles",
              {"region": (1900, 900, 384, 256)}),
             ("lossless", "thumbnail", {"reduce": 4}),
             ("lossy", "one tile", {"region": tile}),
             ("lossy", "window over nine tiles",
              {"region": (1000, 1500, 600, 600)}),
             ("lossy", "thumbnail", {"reduce": 3})]
    sink = ReadSink()
    reader = CudaReader(device="cuda", metrics=sink)
    set_metrics_sink(sink)
    out = {}
    rows = []
    reset_counts()
    try:
        for kind, label, kw in reads:
            with InverseTimer(decoder, ("run_inverse",
                                        "run_region_inverse")) as inv:
                t0 = time.perf_counter()
                cold = reader.read(paths[kind], **kw)
                t_cold = time.perf_counter() - t0
            stages, counters = sink.take()
            t0 = time.perf_counter()
            warm = reader.read(paths[kind], **kw)
            t_warm = time.perf_counter() - t0
            _, warm_counters = sink.take()
            if warm is not cold or warm_counters != {"decode.cache_hits": 1}:
                fail(f"read {kind} {label}: the repeat was not one tile-cache "
                     f"hit ({warm_counters})")
            row = {"read": f"{kind} {label}", "args": kw,
                   "shape": list(cold.shape), "bytes": int(cold.nbytes),
                   "cold_s": t_cold, "warm_s": t_warm,
                   "inverse_event_ms": inv.ms, "inverse_calls": inv.calls,
                   "stages": {k: v[0] for k, v in stages.items()},
                   "decisions": counters.get("decode.mq_symbols", 0),
                   "blocks": counters.get("decode.blocks", 0),
                   "packets_skipped": counters.get("decode.packets_skipped",
                                                   0),
                   "index_builds": counters.get("decode.index_cache_misses",
                                                0)}
            rows.append(row)
            out[(kind, label)] = cold
            st = row["stages"]
            rate = row["decisions"] / max(st.get("decode.mq", 0), 1e-9) / 1e6
            say(f"read {kind} {label} {kw}: out {tuple(cold.shape)} "
                f"{cold.dtype} ({cold.nbytes} B); cold {t_cold:.3f} s = "
                f"t2_parse {st.get('decode.t2_parse', 0):.3f} + mq "
                f"{st.get('decode.mq', 0):.3f} + t1 assembly "
                f"{st.get('decode.t1', 0):.4f} + device inverse (host) "
                f"{st.get('decode.device_inverse', 0):.4f} + index build "
                f"{st.get('decode.index_build', 0):.3f} s; device inverse by "
                f"CUDA events {inv.ms:.3f} ms over {inv.calls} call(s); "
                f"{row['decisions']} MQ decisions in {row['blocks']} "
                f"code-blocks ({rate:.3f} M/s), {row['packets_skipped']} "
                f"packets skipped; warm hit {t_warm * 1e3:.4f} ms")
    finally:
        set_metrics_sink(None)
    counts = read_counts()
    say(f"read: kernel launches in the read path's run {counts} (the read "
        "path runs none of the Tier-1 kernels)")
    if any(counts.values()):
        fail(f"the read path launched a Tier-1 kernel: {counts}")
    builds = sum(r["index_builds"] for r in rows)
    say(f"read: stream index builds {builds} for 2 files")
    if builds != 2:
        fail("the reader did not build one stream index per file")

    x, y, w, h = tile
    _exact("lossless one tile == source crop", out["lossless", "one tile"],
           img[y:y + h, x:x + w])
    _exact("lossless window over four tiles == source crop",
           out["lossless", "window over four tiles"], img[900:1156, 1900:2284])
    with open(paths["lossless"], "rb") as fh:
        data = fh.read()
    t0 = time.perf_counter()
    ref = decode(data, reduce=4, device="cpu")
    say(f"read: lossless thumbnail decoded on the CPU in "
        f"{time.perf_counter() - t0:.2f} s")
    _exact("lossless thumbnail (reduce=4), card == CPU",
           out["lossless", "thumbnail"], ref)
    big = out["lossy", "window over nine tiles"]
    _exact("lossy one tile == crop of the (1000, 1500, 600, 600) window",
           out["lossy", "one tile"], big[36:548, 24:536])
    on_cpu = CudaReader(device="cpu")
    t0 = time.perf_counter()
    cpu_tile = on_cpu.read(paths["lossy"], region=tile)
    cpu_thumb = on_cpu.read(paths["lossy"], reduce=3)
    say(f"read: lossy tile and thumbnail read on the CPU in "
        f"{time.perf_counter() - t0:.2f} s")
    n_tile = _within_one("lossy one tile, card vs CPU",
                         out["lossy", "one tile"], cpu_tile)
    n_thumb = _within_one("lossy thumbnail (reduce=3), card vs CPU",
                          out["lossy", "thumbnail"], cpu_thumb)
    db = psnr(out["lossy", "one tile"], img[y:y + h, x:x + w])
    say(f"read: lossy one tile PSNR against the source {db:.3f} dB")
    for row in rows:
        if row["read"] in ("lossless thumbnail", "lossy one tile"):
            row["device_busy_ms"], row["device_ops"] = profile_inverse(
                reader, paths, row)
    say("read table: " + json.dumps(rows))
    return {"rows": rows, "differ": (n_tile, n_thumb), "psnr": db,
            "pixels": out, "paths": paths}


def profile_inverse(reader, paths: dict, row: dict) -> tuple:
    """One more cold read under torch.profiler: the device's busy time
    (kernel and copy durations) against the inverse's CUDA-event span
    from the unprofiled run, so the rest of that span is the device
    idle between the host's launches."""
    from torch.profiler import ProfilerActivity, profile

    kind, _ = row["read"].split(" ", 1)
    reader.reset_caches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reader.read(paths[kind], **row["args"])
        torch.cuda.synchronize()
    busy = [e.device_time for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time > 0]
    busy_ms = sum(busy) / 1e3
    span = row["inverse_event_ms"]
    say(f"read profile: {row['read']}: {len(busy)} device operations "
        f"(kernels and copies), busy {busy_ms:.3f} ms of the inverse's "
        f"{span:.3f} ms by CUDA events (device idle "
        f"{100 * (1 - busy_ms / span):.1f} % of it), "
        f"{100 * busy_ms / 1e3 / row['cold_s']:.3f} % of the cold read")
    return busy_ms, len(busy)


# --- phase 7: tensors and coefficients -----------------------------------

TENSOR_SIDE = 4096             # one 4096x4096 weight matrix per dtype
ORACLE_BLOCKS = 16             # blocks per limb in the oracle slice


def tensor_inputs(rng) -> dict:
    """Phase 7's tensors on the card, from ``rng``: an int8 quantized
    checkpoint shard (N(0, 2) rounded, clipped to +-7), and one
    projection matrix of a 7B-class model, N(0, 1) * 0.02, in bfloat16
    and in float32."""
    n = TENSOR_SIDE
    q = np.clip(np.rint(rng.normal(0.0, 2.0, (n, n))), -7, 7).astype(np.int8)
    w = rng.standard_normal((n, n), dtype=np.float32) * np.float32(0.02)
    return {"int8": torch.from_numpy(q).cuda(),
            "bfloat16": torch.from_numpy(w).cuda().to(torch.bfloat16),
            "float32": torch.from_numpy(w).cuda()}


def tensor_bits(x) -> np.ndarray:
    """A tensor's elements as unsigned bit patterns on the host (NaN-safe
    equality)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    return x.view(f"u{x.dtype.itemsize}")


def from_bits(bits: np.ndarray, name: str):
    if name == "bfloat16":
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return bits.view(name)


def tensor_encode(x, label: str, kernel: str, **kw) -> dict:
    """One encode_tensor of ``x`` on the card, the launch counts set to 0
    just before and read just after: wall time, the Tier-1 kernel's
    launches by plane budget with CUDA events around each C launch and
    their bounds, symbols, the host replay's time (replay backend) and
    peak device memory."""
    from bucketeer_tpu_torch.codec import cxd, t1_batch
    from bucketeer_tpu_torch.kernels import cxd_scan, fused_t1
    from bucketeer_tpu_torch.tensor import encode_tensor, set_metrics_sink

    split = kernel == "cxd_scan"
    real = getattr(cxd, kernel)
    timer = LaunchTimer(cxd_scan if split else fused_t1, real,
                        _scan_volume if split else _fused_volume)
    replay = StageTimer([("host replay", t1_batch, "encode_cxd")],
                        sync=False)
    sink = ReadSink()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    setattr(cxd, kernel, timer)
    set_metrics_sink(sink)
    try:
        with timer, replay:
            t0 = time.perf_counter()
            blob = encode_tensor(x, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        setattr(cxd, kernel, real)
        set_metrics_sink(None)
    counts = read_counts()
    stages, counters = sink.take()
    bound = scan_bound if split else fused_bound
    by_l: dict = {}
    for (start, stop, vol), b in zip(timer.launches, timer.bounds(bound)):
        ms, bms, blocks = by_l.setdefault(vol[0], ([], [], []))
        ms.append(start.elapsed_time(stop))
        bms.append(b[0])
        blocks.append(vol[1].shape[0])
    raw = x.numel() * x.element_size()
    syms = stages.get("tensor.encode_device", (0, 0, 0))[1]
    kms = timer.kernel_ms()
    per_l = "; ".join(
        f"L={L}: {len(ms)} launches of {min(bl)}-{max(bl)} blocks, "
        f"{sum(ms) / len(ms):.3f} ms/launch (min {min(ms):.3f}, max "
        f"{max(ms):.3f}), bound {sum(bms) / len(bms):.6f} ms/launch"
        for L, (ms, bms, bl) in sorted(by_l.items()))
    line = (f"tensor {label}: wall {wall:.3f} s, {raw / wall / 1e6:.3f} "
            f"MB/s, {raw} B -> {len(blob)} B (ratio {raw / len(blob):.4f}),"
            f" {counters.get('tensor.encode_blocks', 0)} blocks; {kernel} "
            f"{len(timer.launches)} launches, kernel {kms:.3f} ms total by "
            f"CUDA events ({per_l}); {syms} symbols "
            f"({syms / max(kms, 1e-9) / 1e6:.3f} G/s of kernel time); "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if split:
        line += (f"; host MQ replay {replay.seconds['host replay']:.3f} s "
                 f"({t1_batch.default_threads()} threads)")
    say(line + f"; launches in this run {counts}")
    if not timer.launches or counts[kernel] != len(timer.launches):
        fail(f"tensor {label}: {kernel} launched {counts[kernel]} times, "
             f"{len(timer.launches)} timed")
    want = {"fused_t1": not split, "cxd_scan": split, "mq_scan": False,
            "probe": True}
    for name, launched in want.items():
        if (counts[name] > 0) != launched:
            fail(f"tensor {label}: {name} launched {counts[name]} times")
    return {"blob": blob, "wall": wall, "counts": counts, "by_l": by_l,
            "kernel_ms": kms, "symbols": syms}


def oracle_on_host(job) -> tuple:
    """The oracle for one slice, in a worker process (one thread): the
    host reference coder's blob of the slice, and the card's blob of it
    decoded back, as bit patterns; with both times."""
    from bucketeer_tpu_torch.tensor import decode_tensor, encode_tensor

    name, bits, card_blob = job
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    host = encode_tensor(from_bits(bits, name), device="host")
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = tensor_bits(decode_tensor(card_blob))
    return host, back, t_host, time.perf_counter() - t0


def coeffs_on_host(job) -> tuple:
    """CPU coefficient reads of one file in a worker process (one
    thread): the bands of each read as numpy arrays, and the time."""
    from bucketeer_tpu_torch.converters import CudaReader

    path, reads = job
    torch.set_num_threads(1)
    reader = CudaReader(device="cpu")
    t0 = time.perf_counter()
    out = [reader.read_coefficients(path, **kw).to_host() for kw in reads]
    return out, time.perf_counter() - t0


def check_slice_blocks(label: str, slice_blob: bytes, full_blob: bytes):
    """The slice's blocks equal the full blob's first ORACLE_BLOCKS
    blocks of each limb."""
    from bucketeer_tpu_torch.tensor import container

    part, full = container.parse(slice_blob), container.parse(full_blob)
    k = part.spec.n_limbs
    nb = full.blocks_per_limb
    for j in range(k):
        for i in range(ORACLE_BLOCKS):
            a = part.blocks[j * ORACLE_BLOCKS + i]
            b = full.blocks[j * nb + i]
            if (a.nbp, a.kept, a.data) != (b.nbp, b.kept, b.data) or \
                    not np.array_equal(a.cums, b.cums):
                fail(f"tensor {label}: slice block {i} of limb {j} differs "
                     "from the full blob's")


def phase_tensors(rng) -> dict:
    """(a) the three 4096x4096 tensors through encode_tensor on the card:
    the device backend at the default chunk and at chunk_blocks=4096,
    the replay backend once, all byte-identical; (b) the slice of each,
    its first ORACLE_BLOCKS blocks per limb: the card's blob (also the
    warm-up) equals the full blob's blocks, and in worker processes the
    host reference coder's blob, and its decode bit for bit."""
    from bucketeer_tpu_torch.tensor import encode_tensor

    xs = tensor_inputs(rng)
    say("tensor: inputs on the card " + ", ".join(
        f"{k} {tuple(v.shape)} ({v.numel() * v.element_size()} B)"
        for k, v in xs.items()))
    slices, launches = {}, {"fused_t1": 0, "cxd_scan": 0, "probe": 0}
    rows, blobs, walls = [], {}, {}
    for name, x in xs.items():
        part = x.reshape(-1)[:ORACLE_BLOCKS * 4096]
        t0 = time.perf_counter()
        slices[name] = (part, encode_tensor(part))
        torch.cuda.synchronize()
        say(f"tensor {name}: warm-up (the oracle slice, {part.numel()} "
            f"elements) {time.perf_counter() - t0:.3f} s")
        runs = {"chunk 64": tensor_encode(x, f"{name} device chunk 64",
                                          "fused_t1"),
                "chunk 4096": tensor_encode(x, f"{name} device chunk 4096",
                                            "fused_t1", chunk_blocks=4096),
                "replay": tensor_encode(x, f"{name} replay chunk 64",
                                        "cxd_scan", device="replay")}
        ref = blobs[name] = runs["chunk 64"]["blob"]
        walls[name] = runs["chunk 64"]["wall"]
        for label, run in runs.items():
            if label != "chunk 64":
                same = run["blob"] == ref
                say(f"tensor {name}: {label} blob identical to chunk 64's: "
                    f"{same}")
                if not same:
                    fail(f"tensor {name}: the {label} blob differs")
            for k in launches:
                launches[k] += run["counts"][k]
            rows.append({"dtype": name, "run": label, "wall_s": run["wall"],
                         "bytes": len(run["blob"]),
                         "kernel_ms": run["kernel_ms"],
                         "symbols": run["symbols"],
                         "launches": {L: len(v[0])
                                      for L, v in run["by_l"].items()},
                         "ms_per_launch": {L: sum(v[0]) / len(v[0])
                                           for L, v in run["by_l"].items()},
                         "bound_ms_per_launch": {
                             L: sum(v[1]) / len(v[1])
                             for L, v in run["by_l"].items()}})
        check_slice_blocks(name, slices[name][1], ref)
        say(f"tensor {name}: the slice's blocks equal the full blob's "
            f"first {ORACLE_BLOCKS} blocks of each limb")
    say("tensor table: " + json.dumps(rows))
    return {"slices": slices, "launches": launches, "inputs": xs,
            "blobs": blobs, "walls": walls}


def check_oracle(slices: dict, results: dict) -> None:
    for name, (part, card_blob) in slices.items():
        host, back, t_host, t_dec = results[name]
        same = host == card_blob
        exact = np.array_equal(back, tensor_bits(part))
        say(f"tensor oracle {name}: host reference blob ({t_host:.2f} s on "
            f"the host) identical to the card's: {same}; the card's blob "
            f"decodes ({t_dec:.2f} s) to the slice bit for bit: {exact}")
        if not (same and exact):
            fail(f"tensor oracle {name}: host blob identical {same}, round "
                 f"trip exact {exact}")


COEFF_TILE = (1024, 1536, 512, 512)        # phase 6's one-tile window
# (kind, label, read arguments, phase 6's read of the same window)
COEFF_READS = [
    ("lossless", "full reduce=4", {"reduce": 4}, "lossless thumbnail"),
    ("lossy", "full reduce=3", {"reduce": 3}, "lossy thumbnail"),
    ("lossless", "region", {"region": COEFF_TILE}, "lossless one tile"),
    ("lossy", "region", {"region": COEFF_TILE}, "lossy one tile"),
    ("lossless", "region reduce=4", {"region": COEFF_TILE, "reduce": 4},
     None),
    ("lossy", "region reduce=3", {"region": COEFF_TILE, "reduce": 3}, None)]


def check_region_crop(label: str, region_set, full_set) -> None:
    """A region read equals the crop of the full read at the same reduce,
    at the windows the band_window rule gives."""
    from bucketeer_tpu_torch.tensor.coeffs import (band_downsample,
                                                   band_keys, band_window)

    x, y, w, h = COEFF_TILE
    s = 1 << full_set.reduce
    for key in band_keys(full_set.levels):
        d = band_downsample(key[0], full_set.levels)
        fb = full_set.bands[key]
        r0, r1 = band_window(y // s, -(-min(y + h, full_set.height) // s),
                             d, fb.shape[1])
        c0, c1 = band_window(x // s, -(-min(x + w, full_set.width) // s),
                             d, fb.shape[2])
        if region_set.windows[key] != (r0, r1, c0, c1) or not torch.equal(
                region_set.bands[key], fb[:, r0:r1, c0:c1]):
            fail(f"coeffs {label}: band {key} is not the crop of the full "
                 "read")
    say(f"coeffs check: {label} == crop of the full read by band_window "
        f"({len(full_set.bands)} bands, tolerance 0)")


def check_own_set(label: str, warm, cold) -> None:
    """A cache hit is a set of its own: equal to the cold read band for
    band, sharing no storage with it (ROADMAP C.6)."""
    if warm is cold or list(warm.bands) != list(cold.bands):
        fail(f"{label}: the hit is not a set of its own")
    for key, band in cold.bands.items():
        other = warm.bands[key]
        if not torch.equal(other, band) or \
                other.untyped_storage().data_ptr() == \
                band.untyped_storage().data_ptr():
            fail(f"{label}: band {key} of the hit is not an equal copy")


def phase_coeffs(read_rows: list) -> dict:
    """(c) coefficient reads of phase 5's derivatives through
    CudaReader(device="cuda").read_coefficients, each cold then warm
    twice (tile-cache hits, each a set of its own), the launch counts
    set to 0 just before and read just after; then the region-crop checks, every band on the card, and the
    same reads on the CPU (in worker processes) band for band."""
    from bucketeer_tpu_torch.codec.decode import set_metrics_sink
    from bucketeer_tpu_torch.converters import CudaReader
    from bucketeer_tpu_torch.converters.reader import derivative_path
    from bucketeer_tpu_torch.tensor import coeffs

    paths = {kind: derivative_path(f"smoke-fused-{kind}")
             for kind in ("lossless", "lossy")}
    pixel = {row["read"]: row for row in read_rows}
    sink = ReadSink()
    reader = CudaReader(device="cuda", metrics=sink)
    set_metrics_sink(sink)
    out, rows = {}, []
    reset_counts()
    try:
        for kind, label, kw, twin in COEFF_READS:
            with InverseTimer(coeffs, ("run_dequant_inline",)) as dq:
                t0 = time.perf_counter()
                cold = reader.read_coefficients(paths[kind], **kw)
                torch.cuda.synchronize()
                t_cold = time.perf_counter() - t0
            stages, counters = sink.take()
            # Two hits: the first allocates its copy's memory anew, the
            # second finds the allocator's cache warm.
            hits = []
            for _ in range(2):
                t0 = time.perf_counter()
                warm = reader.read_coefficients(paths[kind], **kw)
                hits.append(time.perf_counter() - t0)
                _, warm_counters = sink.take()
                if warm_counters != {"decode.cache_hits": 1}:
                    fail(f"coeffs {kind} {label}: the repeat was not one "
                         f"tile-cache hit ({warm_counters})")
                check_own_set(f"coeffs {kind} {label}", warm, cold)
            t_warm = hits[0]
            st = {k: v[0] for k, v in stages.items()}
            dec = counters.get("decode.mq_symbols", 0)
            row = {"read": f"{kind} {label}", "args": kw,
                   "bands": len(cold.bands), "bytes": cold.nbytes,
                   "cold_s": t_cold, "warm_s": t_warm,
                   "warm_again_s": hits[1], "stages": st,
                   "dequant_event_ms": dq.ms, "decisions": dec,
                   "blocks": counters.get("decode.blocks", 0),
                   "pixel_cold_s": pixel[twin]["cold_s"] if twin else None}
            rows.append(row)
            out[kind, label] = cold
            twin_txt = (f"; phase 6's pixel read of the same window "
                        f"({twin}) {row['pixel_cold_s']:.3f} s cold"
                        if twin else "")
            say(f"coeffs {kind} {label} {kw}: {len(cold.bands)} bands, "
                f"{cold.nbytes} B ({'int32' if cold.reversible else 'float32'}"
                f"); cold {t_cold:.3f} s = t2_parse "
                f"{st.get('decode.t2_parse', 0):.3f} + mq "
                f"{st.get('decode.mq', 0):.3f} + coeff_dequant (host) "
                f"{st.get('decode.coeff_dequant', 0):.4f} + index build "
                f"{st.get('decode.index_build', 0):.3f} s; dequant by CUDA "
                f"events {dq.ms:.3f} ms; {dec} MQ decisions in "
                f"{row['blocks']} code-blocks "
                f"({dec / max(st.get('decode.mq', 0), 1e-9) / 1e6:.3f} M/s);"
                f" {cold.nbytes / t_cold / 1e6:.3f} MB/s of coefficients; "
                f"warm hit {t_warm * 1e3:.4f} ms, again "
                f"{hits[1] * 1e3:.4f} ms (each its own copy of the bands)"
                f"{twin_txt}")
    finally:
        set_metrics_sink(None)
    counts = read_counts()
    say(f"coeffs: kernel launches in the coefficient reads' run {counts} "
        "(the read path runs none of the Tier-1 kernels)")
    if any(counts.values()):
        fail(f"the coefficient reads launched a Tier-1 kernel: {counts}")
    for kind, r in (("lossless", 4), ("lossy", 3)):
        check_region_crop(f"{kind} region reduce={r}",
                          out[kind, f"region reduce={r}"],
                          out[kind, f"full reduce={r}"])
    devices = {str(t.device) for cs in out.values()
               for t in cs.bands.values()}
    say(f"coeffs check: every band on {sorted(devices)}")
    if any(not d.startswith("cuda") for d in devices):
        fail(f"coefficient bands off the card: {devices}")
    say("coeffs table: " + json.dumps(rows))
    return {"out": out, "paths": paths}


def phase_host_checks(tensors: dict, coeff: dict) -> None:
    """The oracle and the CPU coefficient reads in worker processes (one
    thread each), after every timed card run."""
    slices = tensors["slices"]
    jobs = {}
    spawn = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=len(slices) + 2,
                             mp_context=spawn) as pool:
        for name, (part, card_blob) in slices.items():
            jobs[name] = pool.submit(oracle_on_host, (
                name, tensor_bits(part), card_blob))
        for kind in ("lossless", "lossy"):
            kws = [kw for k, _, kw, _ in COEFF_READS if k == kind]
            jobs[kind] = pool.submit(coeffs_on_host,
                                     (coeff["paths"][kind], kws))
        results = {k: f.result() for k, f in jobs.items()}
    say(f"host checks: {len(jobs)} worker processes, "
        f"{time.perf_counter() - t0:.2f} s wall")
    check_oracle(slices, results)
    for kind in ("lossless", "lossy"):
        labels = [label for k, label, _, _ in COEFF_READS if k == kind]
        cpu_sets, t_cpu = results[kind]
        for label, cpu in zip(labels, cpu_sets):
            card = coeff["out"][kind, label].to_host()
            same = card.keys() == cpu.keys() and all(
                card[k].dtype == cpu[k].dtype
                and np.array_equal(card[k], cpu[k]) for k in card)
            say(f"coeffs check: {kind} {label}, card == CPU band for band: "
                f"{same} (tolerance 0)")
            if not same:
                fail(f"coeffs {kind} {label}: the card's bands differ from "
                     "the CPU's")
        say(f"coeffs: the {kind} reads on the CPU took {t_cpu:.2f} s")


# --- phase 8: the cross-request scheduler ----------------------------------

TENSOR_JOBS = 3             # bfloat16 tensors besides phase 7's


def _stage_ms(sink, name: str) -> str:
    """A stage of a Metrics sink: its median (the histogram's
    quarter-octave bucket) and its exact maximum."""
    st = sink.stages.get(name)
    if st is None or not st.count:
        return f"{name} none"
    return (f"{name} p50 {st.hist.percentile(0.5) * 1e3:.3f} ms (bucket), "
            f"max {st.max_s * 1e3:.3f} ms ({st.count} samples)")


def _run_threads(fns: list, label: str) -> tuple:
    """Run the thunks in threads released together (none of which has
    set a CUDA device); returns (results, wall from release to the last
    join with the card synchronized). A thunk's exception fails the
    phase."""
    barrier = threading.Barrier(len(fns) + 1)
    outs = [None] * len(fns)
    errs = [None] * len(fns)

    def client(i):
        barrier.wait()
        try:
            outs[i] = fns[i]()
        except BaseException as exc:
            errs[i] = exc

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            fail(f"{label}: a client hung")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for e in errs:
        if e is not None:
            fail(f"{label}: {type(e).__name__}: {e}")
    return outs, wall


def _wait_for(pred, label: str, limit: float = 120.0) -> None:
    t_end = time.monotonic() + limit
    while not pred():
        if time.monotonic() > t_end:
            fail(f"{label}: timed out")
        time.sleep(0.002)


def _same_bands(label: str, got, ref) -> None:
    from bucketeer_tpu_torch.tensor.coeffs import BandSlice

    for key, band in ref.bands.items():
        mine = got.bands[key]
        if isinstance(mine, BandSlice):
            mine = mine.materialize()
        if not torch.equal(mine, band):
            fail(f"{label}: band {key} differs from phase 7's read")
    say(f"sched check: {label}: {len(ref.bands)} bands equal phase 7's "
        "(tolerance 0)")


def sched_references(seed: int, workdir: str, tensors: dict) -> dict:
    """The direct runs phase 8 is held against, made before its counts are
    set to 0: a second 4096x4096 image from --seed + 1, encoded lossless
    and lossy by encode_jp2 with no scheduler (TIFF read and encode
    timed: its solo walls), and TENSOR_JOBS more bfloat16 4096x4096
    weight matrices from --seed + 2 through encode_tensor (solo walls)."""
    from bucketeer_tpu_torch.codec import encoder, tiff
    from bucketeer_tpu_torch.converters import Conversion, CudaConverter
    from bucketeer_tpu_torch.tensor import encode_tensor

    img2 = photo(np.random.default_rng(seed + 1), SIZE, SIZE)
    src2 = os.path.join(workdir, "smoke-2.tif")
    write_tiff(src2, img2)
    conv = CudaConverter()
    files, walls = {}, {}
    for conversion in (Conversion.LOSSLESS, Conversion.LOSSY):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        im, bits = tiff.read_image(src2)
        files[conversion] = encoder.encode_jp2(
            im, bits, conv.encode_params(SIZE, SIZE, bits, conversion),
            jpx=True, device="cuda")
        torch.cuda.synchronize()
        walls[conversion] = time.perf_counter() - t0
        say(f"sched reference: image 2 {conversion.value} direct "
            f"(TIFF read + encode_jp2, no scheduler) {walls[conversion]:.3f}"
            f" s, {len(files[conversion])} B")
    rng = np.random.default_rng(seed + 2)
    xs, blobs, twalls = [], [], []
    for _ in range(TENSOR_JOBS):
        w = rng.standard_normal((TENSOR_SIDE, TENSOR_SIDE),
                                dtype=np.float32) * np.float32(0.02)
        x = torch.from_numpy(w).cuda().to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blobs.append(encode_tensor(x))
        torch.cuda.synchronize()
        twalls.append(time.perf_counter() - t0)
        xs.append(x)
    say("sched reference: bfloat16 tensors from --seed + 2 encoded solo in "
        + ", ".join(f"{t:.3f}" for t in twalls) + " s")
    return {"img2": img2, "src2": src2, "files2": files, "walls2": walls,
            "xs": [tensors["inputs"]["bfloat16"]] + xs,
            "blobs": [tensors["blobs"]["bfloat16"]] + blobs,
            "twalls": [tensors["walls"]["bfloat16"]] + twalls}


def phase_scheduler(img, main_res: dict, read_res: dict, tensors: dict,
                    coeff: dict, ref: dict) -> dict:
    """Phase 8: concurrent converts, a read under load, merged tensor
    launches, coefficient reads and admission through one
    EncodeScheduler(device="cuda") with a Metrics sink, the launch counts
    set to 0 just before and read just after. Every output is held
    against the direct run of the same input."""
    from bucketeer_tpu_torch.codec import cxd, encoder, t1_batch
    from bucketeer_tpu_torch.converters import (Conversion, CudaConverter,
                                                CudaReader)
    from bucketeer_tpu_torch.engine.scheduler import (
        DeadlineExceeded, EncodeScheduler, QueueFull, SchedulerClosed)
    from bucketeer_tpu_torch.kernels import fused_t1
    from bucketeer_tpu_torch.server.metrics import Metrics
    from bucketeer_tpu_torch.tensor import (coeff_services, coeffs,
                                            decode_to_coefficients,
                                            encode_tensor)

    src, src2 = main_res["src"], ref["src2"]
    files = {1: main_res["files"], 2: ref["files2"]}
    LL, LY = Conversion.LOSSLESS, Conversion.LOSSY
    sink = Metrics()
    s = EncodeScheduler(device="cuda")
    s.set_metrics_sink(sink)
    reset_counts()

    def read_file(path):
        with open(path, "rb") as fh:
            return fh.read()

    # (a) four concurrent converts, then two concurrent split converts.
    conv = CudaConverter(scheduler=s)
    jobs = [(1, LL), (1, LY), (2, LL), (2, LY)]
    torch.cuda.reset_peak_memory_stats()
    outs, wall = _run_threads(
        [lambda i=i, c=c: read_file(conv.convert(
            f"smoke-sched-{i}-{c.value}", src if i == 1 else src2, c))
         for i, c in jobs], "sched converts")
    peak = torch.cuda.max_memory_allocated() / 2**20
    for (i, c), data in zip(jobs, outs):
        if data != files[i][c]:
            fail(f"sched: concurrent convert of image {i} {c.value} "
                 "differs from its direct encode")
    solo = [main_res["walls"][LL], main_res["walls"][LY],
            ref["walls2"][LL], ref["walls2"][LY]]
    rep = sink.report()
    px = 4 * SIZE * SIZE
    say(f"sched converts: 4 concurrent {SIZE}x{SIZE} converts (images 1 and "
        f"2, lossless and lossy) equal their direct encodes; wall "
        f"{wall:.3f} s against {sum(solo):.3f} s of solo walls ("
        + " + ".join(f"{w:.3f}" for w in solo) + "); aggregate "
        f"{px / wall / 1e6:.3f} MPix/s against {px / sum(solo) / 1e6:.3f} "
        f"serial ({sum(solo) / wall:.3f}x); {_stage_ms(sink, 'encode.queue_wait')}"
        f"; {_stage_ms(sink, 'encode.request')}; encode.device_launches "
        f"{rep['counters'].get('encode.device_launches', 0)} (occupancy max "
        f"{rep['values']['encode.batch_occupancy']['max']:.0f}); peak device "
        f"memory {peak:.1f} MiB")
    split = CudaConverter(device_cxd=True, device_mq=False, scheduler=s)
    sjobs = [(1, LY), (2, LL)]
    outs, swall = _run_threads(
        [lambda i=i, c=c: read_file(split.convert(
            f"smoke-sched-split-{i}-{c.value}", src if i == 1 else src2, c))
         for i, c in sjobs], "sched split converts")
    for (i, c), data in zip(sjobs, outs):
        if data != files[i][c]:
            fail(f"sched: concurrent split convert of image {i} {c.value} "
                 "differs from the direct fused encode")
    p5 = main_res["split_walls"]
    say(f"sched split: 2 concurrent split converts (image 1 lossy, image 2 "
        f"lossless) equal the direct fused files; wall {swall:.3f} s (phase "
        f"5's solo split converts of image 1: lossless {p5[LL]:.3f} s, lossy "
        f"{p5[LY]:.3f} s); shared host Tier-1 pool {s.pool_size} worker(s) "
        f"x {t1_batch.default_threads()} replay threads")

    # (b) a read under load: one slot, an encode running, one queued.
    s.configure(max_concurrent=1)
    order, marks = [], {}
    gate = threading.Event()
    p_ll = conv.encode_params(SIZE, SIZE, 8, LL)
    p_ly = conv.encode_params(SIZE, SIZE, 8, LY)

    def tagged(tag, fn, *a, **kw):
        def run():
            marks[tag] = time.perf_counter()
            order.append(tag)
            return fn(*a, **kw)
        return run

    def held():
        gate.wait(timeout=600)
        return encoder.encode_jp2(img, 8, p_ll, jpx=True, device="cuda")

    class TaggingScheduler:
        def read(self, job, **kw):
            return s.read(tagged("read", job), **kw)

    reader = CudaReader(device="cuda", scheduler=TaggingScheduler(),
                        cache_mb=0)
    res = {}

    def start(name, fn):
        t = threading.Thread(target=lambda: res.__setitem__(name, fn()),
                             daemon=True)
        t.start()
        return t

    threads = [start("running", lambda: s.submit(tagged("running", held)))]
    _wait_for(lambda: s.stats()["running"] == 1, "sched read: holder")
    threads.append(start("queued", lambda: s.submit(tagged(
        "queued", encoder.encode_jp2, ref["img2"], 8, p_ly, jpx=True,
        device="cuda"))))
    _wait_for(lambda: s.stats()["waiting"] == 1, "sched read: queued")
    t_read = time.perf_counter()
    threads.append(start("read", lambda: (
        reader.read(read_res["paths"]["lossy"], region=COEFF_TILE),
        time.perf_counter())))
    _wait_for(lambda: s.stats()["waiting"] == 2, "sched read: read queued")
    gate.set()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            fail("sched read: a request hung")
    if set(res) != {"running", "queued", "read"}:
        fail(f"sched read: requests failed: only {sorted(res)} returned")
    pixels, t_done = res["read"]
    say(f"sched read: grant order {order} (one slot; the read arrived "
        "after the queued encode)")
    if order != ["running", "read", "queued"]:
        fail(f"sched read: the read was not granted before the queued "
             f"encode: {order}")
    _exact("sched read: lossy tile through the scheduler == phase 6's read",
           pixels, read_res["pixels"]["lossy", "one tile"])
    if res["running"] != files[1][LL] or res["queued"] != files[2][LY]:
        fail("sched read: an encode of the read-under-load run differs "
             "from its direct encode")
    say(f"sched read: the {pixels.shape} lossy tile waited "
        f"{marks['read'] - t_read:.3f} s for its slot (the running encode "
        f"{marks['read'] - marks['running']:.3f} s) and took "
        f"{t_done - t_read:.3f} s in all; the queued encode waited "
        f"{marks['queued'] - t_read:.3f} s from the read's arrival")
    s.configure(max_concurrent=8)

    # (c) merged tensor launches.
    timer = LaunchTimer(fused_t1, cxd.fused_t1, _fused_volume)
    cxd.fused_t1 = timer
    try:
        with timer:
            blobs, twall = _run_threads(
                [lambda x=x: s.submit_tensor(encode_tensor, x)
                 for x in ref["xs"]], "sched tensors")
    finally:
        cxd.fused_t1 = timer.fn
    for k, (got, want) in enumerate(zip(blobs, ref["blobs"])):
        if got != want:
            fail(f"sched tensors: blob {k} differs from its direct encode"
                 + (" (phase 7's)" if k == 0 else ""))
    rep = sink.report()
    occ = rep["values"]["tensor.batch_occupancy"]
    n_launch = rep["counters"]["tensor.device_launches"]
    ms = [a.elapsed_time(b) for a, b, _ in timer.launches]
    bounds = timer.bounds(fused_bound)
    blocks = [v[1].shape[0] for _, _, v in timer.launches]
    raw = sum(x.numel() * x.element_size() for x in ref["xs"])
    tsolo = sum(ref["twalls"])
    say(f"sched tensors: {len(blobs)} concurrent bfloat16 {TENSOR_SIDE}^2 "
        f"tensors through submit_tensor equal their direct blobs (the "
        f"first is phase 7's); tensor.batch_occupancy max {occ['max']:.0f}, "
        f"mean {occ['mean']:.3f}; tensor.device_launches {n_launch} "
        f"(solo: {64 * len(blobs)}); fused_t1 {len(ms)} launches of "
        f"{min(blocks)}-{max(blocks)} blocks, {sum(ms) / len(ms):.3f} ms per "
        f"launch by CUDA events (min {min(ms):.3f}, max {max(ms):.3f}), "
        f"{sum(ms):.1f} ms in all; bound {sum(b[0] for b in bounds) / len(bounds):.6f}"
        f" ms per launch by {bounds[0][1]}; wall {twall:.3f} s, "
        f"{raw / twall / 1e6:.3f} MB/s aggregate against {tsolo:.3f} s "
        f"solo ({raw / tsolo / 1e6:.3f} MB/s; phase 7's bfloat16 "
        f"{ref['twalls'][0]:.3f} s)")
    if occ["max"] <= 1:
        fail("sched tensors: no launch merged two jobs")

    # (d) coefficient reads: two concurrent misses, then a batch read.
    creader = CudaReader(device="cuda", scheduler=s, cache_mb=0)
    path = coeff["paths"]["lossy"]
    want = coeff["out"]["lossy", "region"]
    sets, cwall = _run_threads(
        [lambda: creader.read_coefficients(path, region=COEFF_TILE)] * 2,
        "sched coefficient reads")
    for k, got in enumerate(sets):
        _same_bands(f"concurrent coefficient read {k}", got, want)
    with open(path, "rb") as fh:
        data = fh.read()

    def batch():
        check, launch = coeffs.current_services()

        def item():
            with coeff_services(check=check,
                                launch=lambda *a: launch(*a, _expected=2)):
                return decode_to_coefficients(data, region=COEFF_TILE)

        return _run_threads([item, item], "sched batch read")

    t0 = time.perf_counter()
    bsets, _ = s.submit_batchread(batch)
    bwall = time.perf_counter() - t0
    for k, got in enumerate(bsets):
        _same_bands(f"batch-read item {k}", got, want)
    rep = sink.report()
    picked = {k: v for k, v in rep["counters"].items()
              if k.startswith(("batchread.", "decode."))}
    say(f"sched coeffs: 2 concurrent read_coefficients misses {cwall:.3f} s;"
        f" a 2-item batch read {bwall:.3f} s, "
        f"batchread.batch_occupancy max "
        f"{rep['values']['batchread.batch_occupancy']['max']:.0f}; "
        f"counters {picked}; {_stage_ms(sink, 'decode.queue_wait')}; "
        f"{_stage_ms(sink, 'batchread.queue_wait')}")
    s.close()
    say("sched report: " + json.dumps(sink.report()["counters"]))

    # (e) admission on a scheduler of its own.
    phase_admission(img, files[1][LL], conv)
    counts = read_counts()
    say(f"sched: launches in the scheduler's run {counts}")
    want_k = {"fused_t1": True, "cxd_scan": True, "mq_scan": False,
              "probe": True}
    for name, launched in want_k.items():
        if (counts[name] > 0) != launched:
            fail(f"sched: {name} launched {counts[name]} times")
    return {"counts": counts}


def phase_admission(img, want: bytes, conv) -> None:
    """queue_depth=2, one slot: two encodes hold the queue (one running,
    one queued); a third submit raises QueueFull; with room for one more,
    a request with deadline_s=0.001 raises DeadlineExceeded; close() with
    one queued waiter raises SchedulerClosed in it, and in the granted
    encode whose next chunk finds the pool closed, and does not hang."""
    from bucketeer_tpu_torch.codec import encoder
    from bucketeer_tpu_torch.converters import Conversion
    from bucketeer_tpu_torch.engine.scheduler import (
        DeadlineExceeded, EncodeScheduler, QueueFull, SchedulerClosed)
    from bucketeer_tpu_torch.server.metrics import Metrics

    p_ll = conv.encode_params(SIZE, SIZE, 8, Conversion.LOSSLESS)
    sink = Metrics()
    s = EncodeScheduler(device="cuda", queue_depth=2, max_concurrent=1)
    s.set_metrics_sink(sink)
    gates = [threading.Event(), threading.Event()]
    res = {}

    def held(k):
        def run():
            gates[k].wait(timeout=600)
            return encoder.encode_jp2(img, 8, p_ll, jpx=True,
                                      device="cuda")
        return run

    def start(name, fn):
        def body():
            try:
                res[name] = fn()
            except BaseException as exc:
                res[name] = exc
        t = threading.Thread(target=body, daemon=True)
        t.start()
        return t

    ta = start("a", lambda: s.submit(held(0)))
    _wait_for(lambda: s.stats()["running"] == 1, "admission: a")
    tb = start("b", lambda: s.submit(held(1)))
    _wait_for(lambda: s.stats()["admitted"] == 2, "admission: b")
    try:
        s.submit(lambda: None)
        fail("admission: a third submit at queue_depth=2 was admitted")
    except QueueFull as exc:
        full = exc
    if not full.retry_after > 0:
        fail("admission: QueueFull without retry_after > 0")
    s.configure(queue_depth=3)
    t0 = time.perf_counter()
    try:
        s.submit(lambda: None, deadline_s=0.001)
        fail("admission: the deadline_s=0.001 request ran")
    except DeadlineExceeded:
        t_dl = time.perf_counter() - t0
    gates[0].set()
    ta.join(timeout=600)
    if res.get("a") != want:
        fail(f"admission: the running encode did not finish with its "
             f"direct file: {res.get('a')!r:.200}")
    # A's finish granted B (the expired ticket is skipped).
    if s.stats()["running"] != 1 or s.stats()["admitted"] != 1:
        fail(f"admission: B was not granted after A: {s.stats()}")
    tc = start("c", lambda: s.submit(lambda: "ran"))
    _wait_for(lambda: s.stats()["admitted"] == 2, "admission: c")
    t0 = time.perf_counter()
    closer = threading.Thread(target=s.close, daemon=True)
    closer.start()
    closer.join(timeout=60)
    t_close = time.perf_counter() - t0
    gates[1].set()
    for t in (closer, tb, tc):
        t.join(timeout=120)
        if t.is_alive():
            fail("admission: close() or a request hung")
    if not isinstance(res.get("c"), SchedulerClosed) or \
            not isinstance(res.get("b"), SchedulerClosed):
        fail(f"admission: after close() the queued waiter got "
             f"{res.get('c')!r} and the held encode {res.get('b')!r}")
    if s.device_threads_alive() or s.stats()["admitted"] != 0:
        fail(f"admission: the scheduler did not wind down: {s.stats()}")
    say(f"sched admission: QueueFull at queue_depth=2 ({full}); "
        f"DeadlineExceeded after {t_dl * 1e3:.3f} ms for deadline_s=0.001; "
        f"close() returned in {t_close:.3f} s, SchedulerClosed in the queued"
        f" waiter and in the granted encode's first dispatch; the running "
        f"encode finished equal to its direct file; counters "
        f"{sink.report()['counters']}")


SERVICE_BATCH = 4           # items of the fused CSV job (b)
SERVICE_SPLIT = 2           # items of the split CSV job (c)


def _object(engine, key_part: str) -> bytes:
    """The fake bucket's one object whose key holds ``key_part``."""
    s3 = engine.s3_client
    keys = [k for k in s3.metadata if key_part in k]
    if len(keys) != 1:
        fail(f"service: {len(keys)} objects named {key_part!r} in the "
             f"fake bucket ({sorted(s3.metadata)})")
    with open(os.path.join(s3.root, keys[0]), "rb") as fh:
        return fh.read()


def _service_engine(workdir: str, name: str, extra: dict,
                    converter=None):
    """An Engine(device="cuda") on a fake S3 bucket and a recording Slack
    client under ``workdir``, its image mount ``workdir`` itself."""
    from bucketeer_tpu_torch import config as cfg
    from bucketeer_tpu_torch import features
    from bucketeer_tpu_torch.engine import (Engine, FakeS3Client,
                                            RecordingSlackClient)

    config = cfg.Config.load(overrides={
        cfg.S3_BUCKET: "smoke",
        cfg.IIIF_URL: "https://iiif.smoke/iiif",
        cfg.SLACK_CHANNEL_ID: "smoke",
        cfg.FILESYSTEM_IMAGE_MOUNT: workdir,
        cfg.FILESYSTEM_CSV_MOUNT: os.path.join(workdir, f"{name}-csv"),
        cfg.S3_REQUEUE_DELAY: 0.05, **extra})
    return Engine(config,
                  flags=features.FeatureFlagChecker(
                      static={features.FS_WRITE_CSV: True}),
                  converter=converter,
                  s3_client=FakeS3Client(os.path.join(workdir,
                                                      f"{name}-s3")),
                  slack_client=RecordingSlackClient(), device="cuda")


async def _run_job(engine, name: str, rows: list, workdir: str) -> float:
    """A CSV job through job_factory and start_job, as the app's upload
    handler runs it, held to its output CSV and Slack message; returns
    the wall until FINALIZE_JOB removed it from the store."""
    import asyncio
    import csv as csv_mod
    import io

    from bucketeer_tpu_torch import config as cfg
    from bucketeer_tpu_torch import job_factory
    from bucketeer_tpu_torch.engine import start_job
    from bucketeer_tpu_torch.utils import path_prefix as pp

    text = "Item ARK,File Name\n" + "".join(
        f"{ark},{fname}\n" for ark, fname in rows)
    prefix = pp.get_prefix(engine.config.get_str(cfg.FILESYSTEM_PREFIX),
                           workdir)
    job = job_factory.create_job(name, text, prefix=prefix)
    job.slack_handle = "smoke"
    async with engine.store.locked():
        await asyncio.to_thread(engine.store.put, job)
    t0 = time.perf_counter()
    await start_job(job, engine.bus, engine.config, engine.flags,
                    store=engine.store)
    t_end = time.monotonic() + 600
    while name in engine.store:
        if time.monotonic() > t_end:
            fail(f"service: job {name} did not finalize")
        await asyncio.sleep(0.01)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = os.path.join(engine.config.get_str(cfg.FILESYSTEM_CSV_MOUNT),
                       f"{name}.csv")
    with open(out, encoding="utf-8") as fh:
        table = list(csv_mod.DictReader(io.StringIO(fh.read())))
    for row in table:
        if row.get("Bucketeer State") != "succeeded" or not \
                row.get("IIIF Access URL"):
            fail(f"service: job {name} item {row.get('Item ARK')} ended "
                 f"{row.get('Bucketeer State')!r}, IIIF Access URL "
                 f"{row.get('IIIF Access URL')!r}")
    if len(table) != len(rows):
        fail(f"service: job {name}'s CSV has {len(table)} rows for "
             f"{len(rows)} items")
    msgs = engine.slack_client.messages
    if not msgs or f"'{name}'" not in msgs[-1]["text"]:
        fail(f"service: no Slack message names job {name}: {msgs}")
    return wall


def _check_journal(journal_dir: str, name: str, items: int) -> str:
    """The durable store after job ``name`` finished: its journal holds
    the job's put, a dispatch and a SUCCEEDED resolve per item and the
    remove; a JobStore reopened on a copy without the remove replays to
    the finished job (every item SUCCEEDED, none remaining), and one
    reopened on the directory itself recovers no live job."""
    from bucketeer_tpu_torch.engine import JobStore
    from bucketeer_tpu_torch.models import WorkflowState

    def job_of(record):
        job = record.get("job")
        return job.get("name") if isinstance(job, dict) else job

    path = os.path.join(journal_dir, "journal.jsonl")
    with open(path, encoding="utf-8") as fh:
        records = [r for r in map(json.loads, filter(str.strip, fh))
                   if job_of(r) == name]
    ops = [r["op"] for r in records]
    want = ["put"] + ["dispatch"] * items + ["resolve"] * items + ["remove"]
    if sorted(ops) != sorted(want) or ops[0] != "put" or \
            ops[-1] != "remove":
        fail(f"service: journal ops of {name}: {ops}")
    states = {r.get("state") for r in records if r["op"] == "resolve"}
    copy = tempfile.mkdtemp(prefix="chip-smoke-journal-")
    try:
        with open(os.path.join(copy, "journal.jsonl"), "w",
                  encoding="utf-8") as fh:
            for r in records[:-1]:
                fh.write(json.dumps(r) + "\n")
        replay = JobStore(journal_dir=copy)
        job = replay.maybe_get(name)
        if job is None or job.remaining() != 0 or any(
                it.workflow_state != WorkflowState.SUCCEEDED
                for it in job.items) or len(job.items) != items:
            fail(f"service: the journal without its remove does not "
                 f"replay to the finished job {name}")
        replay.close()
    finally:
        shutil.rmtree(copy, ignore_errors=True)
    reopened = JobStore(journal_dir=journal_dir)
    live = reopened.names()
    recovery = dict(reopened.recovery)
    reopened.close()
    if live:
        fail(f"service: a reopened store recovers live jobs {live}")
    return (f"journal ops {len(ops)} (put, {items} dispatch, {items} "
            f"resolve {sorted(states)}, remove); replay without the "
            f"remove: the job with {items} items SUCCEEDED, 0 remaining; "
            f"reopened store: no live job, recovery {recovery}")


def phase_service(main_res: dict, ref: dict, workdir: str) -> dict:
    """Phase 9: the service on the card, below HTTP (the card's machine
    has no aiohttp): an Engine(device="cuda") with a fake S3 bucket and a
    recording Slack client, inside one asyncio loop after
    engine.start(), the launch counts set to 0 before each part and read
    after. (a) single-image requests on the bus as the app's load_image
    sends them; (b) a CSV job of SERVICE_BATCH items on the fused path
    with a journal directory; (c) a CSV job of SERVICE_SPLIT items on a
    second Engine configured for the CX/D split."""
    import asyncio

    from bucketeer_tpu_torch import config as cfg
    from bucketeer_tpu_torch import constants as c
    from bucketeer_tpu_torch.converters import Conversion, CudaConverter
    from bucketeer_tpu_torch.engine import IMAGE_WORKER
    from bucketeer_tpu_torch.server.metrics import Metrics

    src, src2 = main_res["src"], ref["src2"]
    LL, LY = Conversion.LOSSLESS, Conversion.LOSSY
    px = SIZE * SIZE
    counts: dict = {}
    journal = os.path.join(workdir, "service-journal")

    def add(part: dict) -> None:
        for k, v in part.items():
            counts[k] = counts.get(k, 0) + v

    async def single(engine) -> None:
        for conversion in (LL, LY):
            reset_counts()
            t0 = time.perf_counter()
            reply = await engine.bus.request_with_retry(IMAGE_WORKER, {
                c.IMAGE_ID: f"svc-{conversion.value}", c.FILE_PATH: src,
                c.CONVERSION_TYPE: conversion.value})
            t_reply = time.perf_counter() - t0
            if not reply.is_success:
                fail(f"service single {conversion.value}: {reply.code} "
                     f"{reply.message}")
            while engine.image_worker.background:
                await asyncio.sleep(0.005)
            t_upload = time.perf_counter() - t0
            part = read_counts()
            add(part)
            data = _object(engine, f"svc-{conversion.value}")
            direct = main_res["walls"][conversion]
            want_n = main_res["launches"][conversion]
            say(f"service single {conversion.value}: reply {t_reply:.3f} s "
                f"({t_reply / direct:.3f}x phase 5's direct convert "
                f"{direct:.3f} s), upload landed at {t_upload:.3f} s; "
                f"fused_t1 launches {part['fused_t1']} (phase 5: {want_n});"
                f" object {len(data)} B equals phase 5's fused file: "
                f"{data == main_res['files'][conversion]}")
            if data != main_res["files"][conversion]:
                fail(f"service single {conversion.value}: the uploaded "
                     "object differs from phase 5's fused file")
            if part["fused_t1"] != want_n:
                fail(f"service single {conversion.value}: fused_t1 "
                     f"launched {part['fused_t1']} times, phase 5 "
                     f"{want_n}")
        reply = await engine.bus.request_with_retry(IMAGE_WORKER, {
            c.IMAGE_ID: "svc-missing",
            c.FILE_PATH: os.path.join(workdir, "no-such-source.tif")})
        say(f"service single missing source: success {reply.is_success}, "
            f"code {reply.code}, {reply.message!r}")
        if reply.is_success:
            fail("service: a request for a missing file succeeded")

    async def batch(engine) -> None:
        rows = [(f"ark:/smoke/{k}{i}", os.path.basename(p))
                for k in "ab" for i, p in ((1, src), (2, src2))]
        sink = Metrics()
        engine.scheduler.set_metrics_sink(sink)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        try:
            wall = await _run_job(engine, "smoke-job", rows, workdir)
        finally:
            engine.scheduler.set_metrics_sink(None)
        peak = torch.cuda.max_memory_allocated() / 2**20
        part = read_counts()
        add(part)
        want = {1: main_res["files"][LL], 2: ref["files2"][LL]}
        for ark, _ in rows:
            key = ark.replace(":", "%3A").replace("/", "%2F")
            if _object(engine, key) != want[int(ark[-1])]:
                fail(f"service batch: the object of {ark} differs from "
                     "the direct encode of its image")
        solo = 2 * (main_res["walls"][LL] + ref["walls2"][LL])
        say(f"service batch: {SERVICE_BATCH}-item CSV job ({SIZE}x{SIZE} "
            f"images 1 and 2, twice each, lossless) finalized, every item "
            f"succeeded and every object equal to its direct encode; wall "
            f"{wall:.3f} s, {SERVICE_BATCH * px / wall / 1e6:.3f} MPix/s "
            f"aggregate, {solo / wall:.3f}x the sum of the solo walls "
            f"({solo:.3f} s); {_stage_ms(sink, 'encode.queue_wait')}; "
            f"{_stage_ms(sink, 'encode.request')}; fused_t1 launches "
            f"{part['fused_t1']}; peak device memory {peak:.1f} MiB")
        if part["fused_t1"] <= 0 or part["cxd_scan"]:
            fail(f"service batch: launches {part}")
        say("service journal: " + _check_journal(journal, "smoke-job",
                                                 SERVICE_BATCH))

    async def split(engine) -> None:
        rows = [("ark:/smoke/s1", os.path.basename(src)),
                ("ark:/smoke/s2", os.path.basename(src2))]
        reset_counts()
        wall = await _run_job(engine, "smoke-split-job", rows, workdir)
        part = read_counts()
        add(part)
        want = {"s1": main_res["files"][LL], "s2": ref["files2"][LL]}
        for ark, _ in rows:
            key = ark.replace(":", "%3A").replace("/", "%2F")
            if _object(engine, key) != want[ark[-2:]]:
                fail(f"service split: the object of {ark} differs from "
                     "the fused file of its image")
        say(f"service split: {SERVICE_SPLIT}-item CSV job on an Engine "
            f"with {cfg.DEVICE_CXD}=true, {cfg.DEVICE_MQ}=false finalized, "
            f"objects equal to the fused files; wall {wall:.3f} s; "
            f"cxd_scan launches {part['cxd_scan']}, fused_t1 "
            f"{part['fused_t1']}")
        if part["cxd_scan"] <= 0 or part["fused_t1"]:
            fail(f"service split: launches {part}")

    async def run() -> None:
        engine = _service_engine(workdir, "service",
                                 {cfg.JOB_JOURNAL_DIR: journal})
        await engine.start()
        try:
            await single(engine)
            await batch(engine)
        finally:
            await engine.close()
        engine = _service_engine(
            workdir, "service-split",
            {cfg.DEVICE_CXD: "true", cfg.DEVICE_MQ: "false"},
            converter=CudaConverter(device="cuda"))
        await engine.start()
        try:
            await split(engine)
        finally:
            await engine.close()

    asyncio.run(run())
    say(f"service: launches in the service's runs {counts}")
    return {"counts": counts}


# --- phase 10: the host Tier-1 on the card ----------------------------------

STRADDLE_TILE = 320         # at 5 levels its sub-bands straddle the 64-grid
STRADDLE_LEVELS = 5
DECODE_WORKERS = 7          # processes decoding the straddle file's strips
ROWS_WINDOW_S = 0.05        # phase 10's scheduler: merge window


def rows_stages(worker: bool) -> list:
    """The rows encode's stages, [(label, module, attribute)]: on the
    encode's own thread (synchronized) or on the host Tier-1 pool."""
    from bucketeer_tpu_torch.codec import encoder, frontend, rate
    from bucketeer_tpu_torch.codec import t1_batch, tiff

    if worker:
        return [("host coder (encode_packed)", t1_batch, "encode_packed"),
                ("distortion rescale", encoder, "_correct_distortions")]
    return [("tiff read", tiff, "read_image"),
            ("mct choice", encoder, "_mct_helps"),
            ("front-end (transform, blockify, stats, packing)", frontend,
             "dispatch_frontend"),
            ("of which packing", frontend, "_pack_bits"),
            ("floor estimate", rate, "estimate_floors"),
            ("payload plan", frontend, "payload_plan"),
            ("payload fetch", frontend, "fetch_payload"),
            ("pcrd + tier-2", encoder, "_finish")]


class PayloadCounter:
    """Counts the rows and bytes frontend.fetch_payload brings to the
    host while installed."""

    def __init__(self):
        self.rows = self.bytes = 0

    def __enter__(self):
        from bucketeer_tpu_torch.codec import frontend

        self.real = frontend.fetch_payload

        def counting(*a):
            out = self.real(*a)
            self.rows += out.shape[0]
            self.bytes += out.nbytes
            return out

        frontend.fetch_payload = counting
        return self

    def __exit__(self, *exc):
        from bucketeer_tpu_torch.codec import frontend

        frontend.fetch_payload = self.real


def decode_strip(job) -> tuple:
    """One strip of a file decoded on the card, in a worker process (one
    host thread): (y0, samples, seconds)."""
    from bucketeer_tpu_torch.codec.decode import decode

    data, y0, y1 = job
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = decode(data, region=(0, y0, SIZE, y1 - y0), device="cuda")
    return y0, out, time.perf_counter() - t0


def phase_rows(img, main_res: dict, ref: dict) -> dict:
    """Phase 10: the host Tier-1 (front-end mode "rows": bit-planes
    packed on the card, the planes each block codes gathered and copied
    to the host, EBCOT and MQ coding in C++ on the host's cores) at
    BASELINE config 1's size. (a) CudaConverter(device_mq=False,
    device_cxd=False), Kakadu recipe, lossless and lossy: the files
    equal phase 5's fused files byte for byte; wall, then a synchronized
    breakdown. (b) tile 320 at 5 levels, lossless: the grid straddles
    the 64x64 code-block grid, so the planes come back to the host and
    the blocks are sliced and coded there (encoder._legacy_tier1); the
    file equals the CPU encode and decodes on the card to the source
    exactly. (c) two concurrent rows converts of two images through one
    scheduler: files equal their solo runs, and the merged front-end
    launches number fewer than the solo runs' sum. The launch counts
    are set to 0 before (a) and read after (c): no kernel runs."""
    import dataclasses

    from bucketeer_tpu_torch.codec import encoder, pipeline, t1_batch
    from bucketeer_tpu_torch.converters import Conversion, CudaConverter
    from bucketeer_tpu_torch.engine import EncodeScheduler
    from bucketeer_tpu_torch.server.metrics import Metrics

    src, src2 = main_res["src"], ref["src2"]
    LL, LY = Conversion.LOSSLESS, Conversion.LOSSY
    h, w = img.shape[:2]
    threads = t1_batch.default_threads()
    reset_counts()

    # (a) the rows main path through CudaConverter.
    conv = CudaConverter(device_mq=False, device_cxd=False)
    walls = {}
    for conversion in (LL, LY):
        torch.cuda.reset_peak_memory_stats()
        with PayloadCounter() as pc:
            t0 = time.perf_counter()
            out = conv.convert(f"smoke-rows-{conversion.value}", src,
                               conversion)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        with open(out, "rb") as fh:
            data = fh.read()
        same = data == main_res["files"][conversion]
        walls[conversion] = wall
        st = conv.last_stats
        say(f"rows {conversion.value} {w}x{h}: wall {wall:.3f} s, "
            f"{h * w / wall / 1e6:.3f} MPix/s, {len(data)} B; payload "
            f"{pc.rows} rows, {pc.bytes} B fetched; blocks {st['blocks']}, "
            f"bytes {st['bytes']}, symbols "
            f"{st.get('symbols', 'not counted by the host coder')}; host "
            f"coder threads {threads}; peak device memory {peak:.1f} MiB "
            f"(fused, phase 5: {main_res['walls'][conversion]:.3f} s); "
            f"file identical to phase 5's fused file: {same}")
        if not same:
            fail(f"rows {conversion.value}: the host Tier-1's file differs "
                 "from the fused path's")
        if "symbols" in st:
            fail("rows: the host coder reported a symbol count it does not "
                 "make")
    for conversion in (LL, LY):
        with StageTimer(rows_stages(False)) as stt, \
                StageTimer(rows_stages(True), sync=False) as wt, \
                PayloadCounter() as pc:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            conv.convert(f"smoke-rows-breakdown-{conversion.value}", src,
                         conversion)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        own = sum(v for k, v in stt.seconds.items()
                  if k != "of which packing")
        say(f"breakdown rows {conversion.value} (synchronized): wall "
            f"{wall:.3f} s = {stt.line()}, other {wall - own:.3f} s; on the "
            f"host Tier-1 pool ({threads} coder threads per call): "
            f"{wt.line()}; payload {pc.rows} rows, {pc.bytes} B; peak "
            f"device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # (b) a straddling grid: host-sliced blocks.
    params = dataclasses.replace(
        conv.encode_params(h, w, 8, LL), tile_size=STRADDLE_TILE,
        levels=STRADDLE_LEVELS)
    state = encoder._grid_aligned(
        pipeline.make_plan(STRADDLE_TILE, STRADDLE_TILE, 3,
                           STRADDLE_LEVELS, True, 8, params.base_delta),
        (STRADDLE_TILE, STRADDLE_TILE))
    if state != "straddle":
        fail(f"tile {STRADDLE_TILE} at {STRADDLE_LEVELS} levels is "
             f"{state!r}, not a straddling grid")
    stages = [("transform + planes to the host", pipeline, "run_tiles"),
              ("host coder (encode_blocks)", t1_batch, "encode_blocks"),
              ("pcrd + tier-2", encoder, "_finish")]
    torch.cuda.reset_peak_memory_stats()
    with StageTimer(stages) as stt:
        t0 = time.perf_counter()
        card = encoder.encode_jp2(img, 8, params, jpx=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    say(f"straddle lossless tile {STRADDLE_TILE} levels {STRADDLE_LEVELS} "
        f"(synchronized): wall {wall:.3f} s, {h * w / wall / 1e6:.3f} "
        f"MPix/s, {len(card)} B = {stt.line()}, block slicing and other "
        f"{wall - sum(stt.seconds.values()):.3f} s; peak device memory "
        f"{peak:.1f} MiB")
    t0 = time.perf_counter()
    cpu = encoder.encode_jp2(img, 8, params, jpx=True, device="cpu")
    say(f"straddle: the same encode with device=\"cpu\" "
        f"{time.perf_counter() - t0:.3f} s; card file identical to the "
        f"CPU file: {card == cpu}")
    if card != cpu:
        fail("straddle: the card's file differs from the CPU encode's")
    rows_of_tiles = np.array_split(
        np.arange(-(-SIZE // STRADDLE_TILE)), DECODE_WORKERS)
    jobs = [(card, int(r[0]) * STRADDLE_TILE,
             min(SIZE, (int(r[-1]) + 1) * STRADDLE_TILE))
            for r in rows_of_tiles if len(r)]
    spawn = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=len(jobs),
                             mp_context=spawn) as pool:
        strips = list(pool.map(decode_strip, jobs))
    back = np.concatenate([out for _, out, _ in sorted(
        strips, key=lambda r: r[0])])
    exact = back.shape == img.shape and np.array_equal(back, img)
    say(f"straddle: decode on the card (codec.decode.decode, "
        f"{len(jobs)} worker processes, one tile-aligned strip each) "
        f"{time.perf_counter() - t0:.2f} s wall, strips "
        + ", ".join(f"{t:.1f}" for _, _, t in strips)
        + f" s; equals the source exactly: {exact}")
    if not exact:
        fail("straddle: the file does not decode to the source")

    # (c) concurrent rows converts merge their front-end launches.
    sink = Metrics()
    sched = EncodeScheduler(device="cuda", window_s=ROWS_WINDOW_S)
    sched.set_metrics_sink(sink)
    sconv = CudaConverter(device_mq=False, device_cxd=False,
                          scheduler=sched)

    def launches() -> int:
        return sink.report().get("counters", {}).get(
            "encode.device_launches", 0)

    def convert(i, tag):
        out = sconv.convert(f"smoke-rows-sched-{tag}-{i}",
                            src if i == 1 else src2, LL)
        with open(out, "rb") as fh:
            return fh.read()

    solo, solo_walls, solo_launches = {}, {}, 0
    try:
        for i in (1, 2):
            before = launches()
            t0 = time.perf_counter()
            solo[i] = convert(i, "solo")
            torch.cuda.synchronize()
            solo_walls[i] = time.perf_counter() - t0
            solo_launches += launches() - before
        for i, want in ((1, main_res["files"][LL]), (2, ref["files2"][LL])):
            if solo[i] != want:
                fail(f"rows sched: image {i}'s solo rows convert differs "
                     "from its direct fused encode")
        before = launches()
        torch.cuda.reset_peak_memory_stats()
        outs, wall = _run_threads(
            [lambda i=i: convert(i, "pair") for i in (1, 2)],
            "rows sched pair")
        pair_launches = launches() - before
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        sched.close()
    occ = sink.report()["values"]["encode.batch_occupancy"]
    same = [outs[k] == solo[k + 1] for k in range(2)]
    say(f"rows sched: 2 concurrent lossless rows converts (images 1 and 2) "
        f"equal their solo runs: {same}; wall {wall:.3f} s against "
        f"{sum(solo_walls.values()):.3f} s of solo walls ("
        + " + ".join(f"{solo_walls[i]:.3f}" for i in (1, 2))
        + f"); front-end launches {pair_launches} against {solo_launches} "
        f"solo (occupancy max {occ['max']:.0f}, merge window "
        f"{ROWS_WINDOW_S * 1e3:.0f} ms, at most {sched.max_batch_tiles} "
        f"tiles); host Tier-1 pool {sched.pool_size} worker(s) x "
        f"{threads} coder threads; peak device memory {peak:.1f} MiB")
    if not all(same):
        fail("rows sched: a concurrent convert differs from its solo run")
    if pair_launches >= solo_launches:
        fail(f"rows sched: {pair_launches} front-end launches for the "
             f"pair, not fewer than the solo runs' {solo_launches}")
    counts = read_counts()
    say(f"rows: launches in phase 10's runs {counts} (the host Tier-1 "
        "path runs no kernel)")
    if any(counts.values()):
        fail(f"rows: phase 10 launched kernels {counts}")
    return {"counts": counts}


# --- phase 11: the mesh and batches on the card ------------------------------

MESH_SHARDS = 4             # entries of (a)'s and (b)'s meshes: the card, repeated
MESH_SIZE = 8192            # (b): the least square at or above the mesh threshold
BATCH_REDUCE = 4            # (c): resolution levels the batch read drops
BATCH_PLANES = 26           # (c): the progressive cut held against a floored encode


def halo_bytes(comps: int, width: int, levels: int, shards: int) -> int:
    """Bytes the row-sharded DWT copies between row-neighbour shards: at
    each level every inner boundary sends HALO rows of 4-byte samples
    each way."""
    from bucketeer_tpu_torch.parallel.sharded_dwt import HALO

    return sum((shards - 1) * 2 * HALO * comps * (width >> lvl) * 4
               for lvl in range(levels))


class MeshEvents:
    """CUDA events around a mesh transform's device work: recorded on
    entry to ``module.<name>`` and on the return of each of its calls
    to ``module.<last>`` (the step before the planes go to the host)."""

    def __init__(self, module, name: str, last: str):
        self.module, self.name, self.last = module, name, last
        self.pairs = []

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        self.real_last = getattr(self.module, self.last)

        def entry(*a):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.pairs.append([start, None])
            return self.real(*a)

        def last(*a):
            out = self.real_last(*a)
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            self.pairs[-1][1] = stop
            return out

        setattr(self.module, self.name, entry)
        setattr(self.module, self.last, last)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        setattr(self.module, self.last, self.real_last)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def mesh_stages(module, name: str) -> list:
    """A mesh encode's stages: the transform on the mesh (planes back
    on the host), the host block coder, PCRD + Tier-2; block slicing is
    the rest of the wall."""
    from bucketeer_tpu_torch.codec import encoder, t1_batch

    return [(f"transform on the mesh ({name}, planes to the host)",
             module, name),
            ("host coder (encode_blocks)", t1_batch, "encode_blocks"),
            ("pcrd + tier-2", encoder, "_finish")]


def mesh_encode(label: str, encode, stages, events, pixels: int) -> tuple:
    """One mesh encode, synchronized stage by stage, the launch counts
    set to 0 before and read after (the mesh path runs no kernel)."""
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with StageTimer(stages) as stt, events:
        t0 = time.perf_counter()
        data = encode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    counts = read_counts()
    say(f"mesh {label} (synchronized): wall {wall:.3f} s, "
        f"{pixels / wall / 1e6:.3f} MPix/s, {len(data)} B = {stt.line()}, "
        f"block slicing and other {wall - sum(stt.seconds.values()):.3f} s;"
        f" transform {events.ms():.3f} ms on the card by CUDA events; peak "
        f"device memory {peak:.1f} MiB; launches {counts}")
    if any(counts.values()):
        fail(f"mesh {label}: the mesh path launched kernels {counts}")
    return data, wall


def phase_mesh(img, main_res: dict, ref: dict, workdir: str,
               seed: int) -> dict:
    """Phase 11: the mesh and the batch data plane on the card. (a) phase
    5's image as one tile, lossless, 6 levels, on a 1 x MESH_SHARDS mesh
    of the card repeated (row shards with halo copies): the file equals
    the single-device encode; then the lossy transform alone against
    run_tiles. (b) a MESH_SIZE^2 TIFF from --seed + 3, Kakadu recipe,
    lossless, on a MESH_SHARDS x 1 mesh of the card repeated: the file
    equals CudaConverter().convert's, which on one card does not route
    (and, with two cards or more, the converter's own routed file too).
    (c) a batch read through get_scheduler("cuda").submit_batchread, the
    launch counts set to 0 before and read after: phase 5's and phase
    8's lossless derivatives, a copy of the first and a truncated copy,
    reduce BATCH_REDUCE; one failed item, the bands equal to per-image
    coefficient reads and on the card; encode_batch launches fused_t1
    and round-trips exactly; the progressive cut equals a floored
    encode."""
    import dataclasses

    from bucketeer_tpu_torch.batches import (BatchRecipe, assemble_batch,
                                             decode_batch, encode_batch,
                                             truncate_batch)
    from bucketeer_tpu_torch.codec import cxd, encoder, pipeline, tiff
    from bucketeer_tpu_torch.converters import (Conversion, CudaConverter,
                                                CudaReader)
    from bucketeer_tpu_torch.converters.cuda import DEFAULT_MESH_MIN_PIXELS
    from bucketeer_tpu_torch.engine import get_scheduler
    from bucketeer_tpu_torch.kernels import fused_t1
    from bucketeer_tpu_torch.parallel import batch as pbatch
    from bucketeer_tpu_torch.parallel import make_mesh
    from bucketeer_tpu_torch.parallel import sharded_dwt as sdwt
    from bucketeer_tpu_torch.server.metrics import Metrics

    LL, LY = Conversion.LOSSLESS, Conversion.LOSSY
    h, w = img.shape[:2]
    conv = CudaConverter()
    cards = torch.cuda.device_count()

    # (a) one tile, rows split over the mesh.
    params = dataclasses.replace(conv.encode_params(h, w, 8, LL),
                                 tile_size=None)
    spatial = make_mesh(["cuda:0"] * MESH_SHARDS, tile_parallel=MESH_SHARDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = encoder.encode_jp2(img, 8, params, jpx=True, device="cuda")
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    got, wall = mesh_encode(
        f"spatial {spatial.shape} lossless {w}x{h} one tile, "
        f"{params.levels} levels",
        lambda: encoder.encode_jp2(img, 8, params, jpx=True, mesh=spatial,
                                   device="cuda"),
        mesh_stages(sdwt, "sharded_transform_tile"),
        MeshEvents(sdwt, "sharded_transform_tile", "_epilogue"), h * w)
    say(f"mesh spatial: {h // MESH_SHARDS} rows per shard, "
        f"{h // MESH_SHARDS >> params.levels} at the coarsest level; halo "
        f"copies {halo_bytes(3, w, params.levels, MESH_SHARDS)} B; the "
        f"single-device encode (fused device Tier-1) {single_wall:.3f} s; "
        f"file identical to it: {got == single}")
    if got != single:
        fail("mesh spatial: the file differs from the single-device encode")
    lp = conv.encode_params(h, w, 8, LY)
    plan = pipeline.make_plan(
        h, w, 3, lp.levels, False, 8, lp.base_delta,
        use_mct=encoder._mct_helps(img, False, lp.rate, lp.base_delta))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = sdwt.sharded_transform_tile(plan, img, spatial)
    t_sharded = time.perf_counter() - t0
    whole = pipeline.run_tiles(plan, img[None], device="cuda")[0]
    diff = np.abs(sharded.astype(np.int64) - whole)
    n_diff = int(np.count_nonzero(diff))
    say(f"mesh spatial lossy transform (9/7 + ICT, fixed point): sharded "
        f"{t_sharded:.3f} s with the copy to the host; against run_tiles "
        f"max |delta| {int(diff.max())} index, {n_diff} of {diff.size} "
        f"samples differ ({n_diff / diff.size:.6%})")
    if diff.max() > 1 or n_diff >= 0.01 * diff.size:
        fail("mesh spatial lossy: the sharded transform strays from "
             "run_tiles")
    del sharded, whole, diff

    # (b) a tiled image at the converter's threshold, tiles split over
    # the data axis.
    big = photo(np.random.default_rng(seed + 3), MESH_SIZE, MESH_SIZE)
    src = os.path.join(workdir, "smoke-map.tif")
    write_tiff(src, big)
    H = W = MESH_SIZE
    if H * W < DEFAULT_MESH_MIN_PIXELS:
        fail(f"{H}x{W} is below the mesh threshold")
    bparams = conv.encode_params(H, W, 8, LL)
    routed = conv._choose_mesh(H, W, bparams)
    say(f"mesh data: {W}x{H} ({H * W / 1e6:.1f} MPix) against the threshold "
        f"{DEFAULT_MESH_MIN_PIXELS}; {cards} card(s): the converter's mesh "
        f"{None if routed is None else routed.shape}")
    if cards == 1 and routed is not None:
        fail("mesh data: the converter routed an image on one card")
    single_conv = CudaConverter(mesh_min_pixels=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(single_conv.convert("smoke-map", src, LL), "rb") as fh:
        want = fh.read()
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    data_mesh = make_mesh(["cuda:0"] * MESH_SHARDS, tile_parallel=1)
    sched = get_scheduler("cuda")

    def mesh_convert():
        im, bits = tiff.read_image(src)
        return sched.encode_jp2(im, bits, bparams, jpx=True, mesh=data_mesh)

    got, wall = mesh_encode(
        f"data {data_mesh.shape} lossless {W}x{H} tile {bparams.tile_size} "
        f"(TIFF read included)", mesh_convert,
        mesh_stages(pbatch, "run_tiles_sharded"),
        MeshEvents(pbatch, "run_tiles_sharded", "_transform_batch"), H * W)
    say(f"mesh data: the single-device convert (fused device Tier-1) "
        f"{ref_wall:.3f} s, {H * W / ref_wall / 1e6:.3f} MPix/s; file "
        f"identical to it: {got == want}")
    if got != want:
        fail("mesh data: the file differs from CudaConverter().convert's")
    if cards >= 2:
        t0 = time.perf_counter()
        with open(conv.convert("smoke-map-routed", src, LL), "rb") as fh:
            across = fh.read()
        say(f"mesh data: across the {cards} cards through the converter "
            f"{time.perf_counter() - t0:.3f} s; identical: {across == want}")
        if across != want:
            fail("mesh data: the converter's routed file differs")
    else:
        say("mesh data: one card, so the run across cards was not made")
    del big

    # (c) a batch read on the card.
    first, second = main_res["files"][LL], ref["files2"][LL]
    blobs = {"smoke-1": first, "smoke-2": second, "smoke-1-copy": first,
             "smoke-1-cut": first[:len(first) // 2]}
    paths = {}
    for image_id in ("smoke-1", "smoke-2"):
        paths[image_id] = os.path.join(workdir, f"{image_id}-batch.jpx")
        with open(paths[image_id], "wb") as fh:
            fh.write(blobs[image_id])
    reader = CudaReader(device="cuda")
    refs = {i: reader.read_coefficients(p, reduce=BATCH_REDUCE).to_host()
            for i, p in paths.items()}
    layout = "sharded" if 3 % cards == 0 else "replicated"
    recipe = BatchRecipe(ids=tuple(blobs), reduce=BATCH_REDUCE,
                         layout=layout)
    sink = Metrics()
    sched.set_metrics_sink(sink)
    reset_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = sched.submit_batchread(assemble_batch, recipe,
                                        data_for=blobs.get, device="cuda")
        torch.cuda.synchronize()
        asm_wall = time.perf_counter() - t0
    finally:
        sched.set_metrics_sink(None)
    report = sink.report()
    counters = report.get("counters", {})
    occ = report.get("values", {}).get("batchread.batch_occupancy", {})
    failed = [e for e in result.manifest if not e["ok"]]
    say(f"batch: {len(blobs)} items, reduce {BATCH_REDUCE}, layout "
        f"{result.layout} over {result.meta['n_devices']} device(s): "
        f"assembly {asm_wall:.3f} s; dequantizer launches "
        f"{counters.get('batchread.device_launches', 0)} for "
        f"{counters.get('batchread.merged_images', 0)} images (occupancy "
        f"max {occ.get('max', 0):.0f}); manifest {result.manifest}")
    if len(failed) != 1 or failed[0]["id"] != "smoke-1-cut":
        fail(f"batch: the manifest's failures are {failed}, not the "
             "truncated copy alone")
    if result.ids != ("smoke-1", "smoke-2", "smoke-1-copy"):
        fail(f"batch: surviving ids {result.ids}")
    host = result.to_host()
    for key, arr in host.items():
        want_band = np.stack([refs[i][key] for i in
                              ("smoke-1", "smoke-2", "smoke-1")])
        if not np.array_equal(arr, want_band):
            fail(f"batch: band {key} differs from the coefficient reads")
    off = [key for key, parts in result.bands.items()
           if any(p.device.type != "cuda" for p in parts)]
    if off:
        fail(f"batch: bands {off} are not on the card")
    say(f"batch: {len(host)} bands ({result.nbytes} B) equal the stacked "
        f"coefficient reads (CudaReader.read_coefficients) band for band; "
        f"every band on the card")
    timer = LaunchTimer(fused_t1, cxd.fused_t1, _fused_volume)
    cxd.fused_t1 = timer
    try:
        with timer:
            t0 = time.perf_counter()
            blob = encode_batch(result)
            torch.cuda.synchronize()
            enc_wall = time.perf_counter() - t0
    finally:
        cxd.fused_t1 = timer.fn
    kms = timer.kernel_ms()
    bound = sum(b[0] for b in timer.bounds(fused_bound))
    _, back = decode_batch(blob)
    exact = set(back) == set(host) and all(
        np.array_equal(back[k], host[k]) for k in host)
    cut = truncate_batch(blob, BATCH_PLANES)
    _, cut_bands = decode_batch(cut)
    _, floored = decode_batch(encode_batch(result, planes=BATCH_PLANES))
    same_cut = all(np.array_equal(cut_bands[k], floored[k]) for k in host)
    counts = read_counts()
    say(f"batch: encode_batch {enc_wall:.3f} s, {len(blob)} B; fused_t1 "
        f"{len(timer.launches)} launches, kernel {kms:.3f} ms by CUDA "
        f"events, bound {bound:.6f} ms; round trip exact: {exact}; "
        f"truncate_batch(planes={BATCH_PLANES}) ({len(cut)} B) equals the "
        f"floored encode after decode: {same_cut}; launches in (c) {counts}")
    if not timer.launches or counts["fused_t1"] < len(timer.launches):
        fail(f"batch: encode_batch launched fused_t1 {counts['fused_t1']} "
             f"times, {len(timer.launches)} timed")
    if not exact:
        fail("batch: the stored batch does not decode to its bands")
    if not same_cut:
        fail("batch: the progressive cut differs from the floored encode")
    return {"counts": counts}


# --- phase 12: the defaults and the analysis ---------------------------

PLACEMENT_SIDE = 512        # (a): a corner of phase 5's image, one tile
MERGE_TILE = 256            # (b): two tiles of phase 5's image
MERGE_WINDOW_S = 2.0        # (b): the scheduler's merge window
RACE_SCHEDULES = 8          # (c): interleavings per race scenario


def _placement_encode(label: str, crop, params, device: str) -> dict:
    """One encode_jp2 with the launch counts set to 0 just before and
    read just after, and the calls the encoder made to the two Tier-1
    kernels' wrappers counted (on the CPU a wrapper runs its plain
    version, which counts no launch)."""
    from bucketeer_tpu_torch.codec import cxd, encoder

    calls = {"fused_t1": 0, "cxd_scan": 0}
    real = {name: getattr(cxd, name) for name in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    mode = encoder._tier1_mode(params, device)
    for name in calls:
        setattr(cxd, name, counted(name))
    reset_counts()
    try:
        t0 = time.perf_counter()
        data = encoder.encode_jp2(crop, 8, params, jpx=True, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(cxd, name, fn)
    counts = read_counts()
    say(f"placement {label}: device_mq={params.device_mq}, device "
        f"{device}: Tier-1 mode {mode!r}, {len(data)} B in {wall:.3f} s; "
        f"kernel launches {counts}, wrapper calls {calls}")
    return {"data": data, "counts": counts, "calls": calls, "mode": mode}


def phase_defaults(img) -> dict:
    """(a) the default Tier-1 placement: encode_jp2 of a 512x512 corner
    of phase 5's image (Kakadu recipe, lossless) with default parameters
    on the card runs the fused kernel and gives the bytes of
    device_mq=True; on the CPU the defaults take the host Tier-1 (no
    kernel wrapper is called, no kernel launches) and give the same
    lossless bytes. (b) the default front-end mode: two requests through
    one EncodeScheduler(device="cuda") call dispatch_frontend without a
    mode, each holding its slot before either dispatches, and their
    tiles go to the card in one merged launch whose windows equal solo
    launches. (c) the port's lint (--strict) and race explorer over its
    serving core (--race at RACE_SCHEDULES interleavings per default
    scenario), in a process of their own: both clean."""
    from bucketeer_tpu_torch.codec import encoder, frontend
    from bucketeer_tpu_torch.codec.pipeline import make_plan
    from bucketeer_tpu_torch.engine.scheduler import (EncodeScheduler,
                                                      _SlicedPending)
    from bucketeer_tpu_torch.server.metrics import Metrics

    # (a)
    side = PLACEMENT_SIDE
    crop = np.ascontiguousarray(img[:side, :side])
    params = encoder.EncodeParams.kakadu_recipe(lossless=True)
    params.tile_size = None
    runs = {label: _placement_encode(
        label, crop, dataclasses.replace(params, device_mq=mq), device)
        for label, device, mq in (("card default", "cuda", None),
                                  ("card device_mq=True", "cuda", True),
                                  ("cpu default", "cpu", None))}
    card, forced, cpu = (runs["card default"], runs["card device_mq=True"],
                         runs["cpu default"])
    if card["mode"] != "mq" or card["counts"]["fused_t1"] <= 0 \
            or card["calls"]["fused_t1"] <= 0:
        fail("placement: the card's default encode did not launch fused_t1")
    if card["data"] != forced["data"]:
        fail("placement: the card's default bytes differ from "
             "device_mq=True's")
    if cpu["mode"] != "rows" or any(cpu["counts"].values()) \
            or any(cpu["calls"].values()):
        fail("placement: the CPU's default encode ran a Tier-1 kernel")
    if cpu["data"] != card["data"]:
        fail("placement: the CPU's default lossless bytes differ from the "
             "card's")
    say(f"placement: card default == device_mq=True == cpu default "
        f"(host Tier-1), {len(card['data'])} B")
    launched = {name: card["counts"][name] + forced["counts"][name]
                for name in card["counts"]}

    # (b)
    t = MERGE_TILE
    plan = make_plan(t, t, 3, 5, True, 8, params.base_delta, use_mct=True)
    tiles = [np.ascontiguousarray(img[0:t, i * t:(i + 1) * t])[None]
             for i in range(2)]
    sink = Metrics()
    sched = EncodeScheduler(device="cuda", window_s=MERGE_WINDOW_S,
                            max_concurrent=4)
    sched.set_metrics_sink(sink)
    both_admitted = threading.Barrier(2)

    def request(i):
        def body():
            both_admitted.wait(timeout=60)
            return sched.dispatch_frontend(plan, tiles[i])
        return sched.submit(body)

    try:
        outs, wall = _run_threads([lambda i=i: request(i) for i in (0, 1)],
                                  "default-mode pair")
        merged = [o.resolve_stats() for o in outs]
    finally:
        sched.close()
    rep = sink.report()
    n_launches = rep["counters"].get("encode.device_launches", 0)
    occupancy = rep["values"]["encode.batch_occupancy"]["max"]
    solo = [frontend.dispatch_frontend(plan, tiles[i], device="cuda")
            .resolve_stats() for i in (0, 1)]
    same = []
    for got, want in zip(merged, solo):
        P = got.layout.P
        lo, n = got.block_base * (P + 1), got.n_blocks * (P + 1)
        same.append(
            all(np.array_equal(getattr(got, f), getattr(want, f))
                for f in ("nbps", "newsig", "sigd", "refd"))
            and torch.equal(got.rows[lo:lo + n], want.rows))
    say(f"default mode: 2 concurrent dispatch_frontend calls without a "
        f"mode: {n_launches} front-end launch(es), occupancy max "
        f"{occupancy:.0f}, windows {[type(o).__name__ for o in outs]}, "
        f"each equal to a solo launch: {same}; wall {wall:.3f} s")
    if n_launches != 1 or occupancy != 2 or \
            not all(isinstance(o, _SlicedPending) for o in outs):
        fail(f"default mode: the pair made {n_launches} launches, not one "
             "merged launch")
    if not all(same):
        fail("default mode: a request's window differs from its solo launch")

    # (c)
    summary_path = os.path.join(tempfile.mkdtemp(prefix="chip-race-"),
                                "race.json")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "bucketeer_tpu_torch.analysis",
             "--strict", "--race", "--race-schedules", str(RACE_SCHEDULES),
             "--race-budget-s", "240", "--race-summary-json",
             summary_path], cwd=root, capture_output=True, text=True,
            timeout=420, env={**os.environ, "PYTHONPATH": root})
    except subprocess.TimeoutExpired:
        fail("analysis: the lint and race run did not finish in 420 s")
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("graftrace:", "graftlint:"))]
    for ln in lines:
        say(f"analysis: {ln}")
    if proc.returncode != 0:
        fail(f"analysis: exit {proc.returncode}:\n{proc.stdout[-3000:]}"
             f"{proc.stderr[-2000:]}")
    with open(summary_path) as fh:
        summary = json.load(fh)
    shutil.rmtree(os.path.dirname(summary_path), ignore_errors=True)
    bad = {k: summary[k] for k in ("races", "lock_cycles", "deadlocks",
                                   "invariant_failures", "divergences")
           if summary[k]}
    n_scn = len(summary["scenarios"])
    say(f"analysis: lint --strict and --race clean in {wall:.1f} s: "
        f"{summary['interleavings']} interleavings over {n_scn} "
        f"scenarios, {len(summary['crosscheck']['validated_fields'])} "
        "fields validated against the static lock inference")
    if bad or n_scn != 10 or \
            summary["interleavings"] != RACE_SCHEDULES * n_scn:
        fail(f"analysis: race summary {bad}, {n_scn} scenarios, "
             f"{summary['interleavings']} interleavings")
    counts = read_counts()
    return {"counts": {name: launched[name] + counts[name]
                       for name in launched}}


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
    worst, timing = phase_kernel_vs_plain(rng, img)
    probe = phase_probe()
    phase_parity(rng)
    workdir = tempfile.mkdtemp(prefix="chip-smoke-")
    os.environ["BUCKETEER_TMPDIR"] = workdir
    try:
        main_res = phase_main(img, workdir)
        for L in (8, 16):
            frac, group = main_res["lossy_groups"][L]
            label = "image group (lossy, rate-estimator floors)"
            res = check_group(label, L, frac, group)
            for k, v in res["errs"].items():
                worst[k] = max(worst[k], v)
            worst["fused_t1"] = max(worst["fused_t1"],
                                    check_chain("lossy", L, res))
            time_group("lossy", L, frac, group, res)
        read_res = phase_read(img)
        t7 = time.perf_counter()
        tensors = phase_tensors(rng)
        coeff = phase_coeffs(read_res["rows"])
        phase_host_checks(tensors, coeff)
        say(f"phase 7 (tensors and coefficients) "
            f"{time.perf_counter() - t7:.1f} s")
        t8 = time.perf_counter()
        ref = sched_references(args.seed, workdir, tensors)
        sched = phase_scheduler(img, main_res, read_res, tensors, coeff,
                                ref)
        say(f"phase 8 (the scheduler) {time.perf_counter() - t8:.1f} s")
        t9 = time.perf_counter()
        service = phase_service(main_res, ref, workdir)
        say(f"phase 9 (the service) {time.perf_counter() - t9:.1f} s")
        t10 = time.perf_counter()
        phase_rows(img, main_res, ref)
        say(f"phase 10 (the host Tier-1) {time.perf_counter() - t10:.1f} s")
        t11 = time.perf_counter()
        mesh = phase_mesh(img, main_res, ref, workdir, args.seed)
        say(f"phase 11 (the mesh and batches) "
            f"{time.perf_counter() - t11:.1f} s")
        t12 = time.perf_counter()
        defaults = phase_defaults(img)
        say(f"phase 12 (the defaults and the analysis) "
            f"{time.perf_counter() - t12:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"total {time.perf_counter() - t_start:.1f} s")

    counts = main_res["counts"]
    tl = tensors["launches"]
    sl = sched["counts"]
    vl = service["counts"]
    bl = mesh["counts"]
    dl = defaults["counts"]
    launches = {"fused_t1": (counts["fused"]["fused_t1"] + tl["fused_t1"]
                             + sl["fused_t1"] + vl["fused_t1"]
                             + bl["fused_t1"] + dl["fused_t1"]),
                "cxd_scan": (counts["split"]["cxd_scan"] + tl["cxd_scan"]
                             + sl["cxd_scan"] + vl["cxd_scan"]
                             + bl["cxd_scan"] + dl["cxd_scan"]),
                "probe": (counts["fused"]["probe"] + counts["split"]["probe"]
                          + tl["probe"] + sl["probe"] + vl["probe"]
                          + bl["probe"] + dl["probe"]),
                # No encode path runs mq_scan (the JAX package has no call
                # site for mq_pallas either): its count is the whole run's,
                # every launch a check against plain or fused_t1.
                "mq_scan": (RUN_LAUNCHES.get("mq_scan", 0)
                            + libraries()["mq_scan"].launches)}
    paths = {"fused_t1": "fused main path (converts through the "
                         "process-wide scheduler); tensor codec, device "
                         "backend; the scheduler's concurrent converts and "
                         "merged tensor launches (phase 8); the service's "
                         "single-image requests and fused CSV job (phase 9);"
                         " the stored batch's bands (encode_batch, phase 11)"
                         "; encode_jp2 with default parameters on the card "
                         "(phase 12)",
             "cxd_scan": "split main path (through the process-wide "
                         "scheduler); tensor codec, replay backend; the "
                         "scheduler's concurrent split converts (phase 8); "
                         "the service's split CSV job (phase 9)",
             "probe": "first launch of each main path, tensor encode, "
                      "the scheduler's phase, each service part, the "
                      "batch phase and the default-placement encodes",
             "mq_scan": "none: the oracle surface; launches of the whole "
                        "run's kernel checks"}
    source = {"fused_t1": "fused_t1.cu", "cxd_scan": "cxd_scan.cu",
              "mq_scan": "mq_scan.cu", "probe": "probe.cu"}
    replaces = {"fused_t1": "fused_t1.py:72", "cxd_scan": "cxd_scan.py:121",
                "mq_scan": "mq_scan.py:74", "probe": "support.py:47"}
    timing["probe"] = probe
    worst["probe"] = probe["max_abs_err"]
    say(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": CSRC + source[name],
        "replaces": TPU + replaces[name], "launches": launches[name],
        "max_abs_err": worst[name], "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name].get("library_ms"),
        "matches_plain": worst[name] == 0, "path": paths[name]}
        for name in ("fused_t1", "cxd_scan", "mq_scan", "probe")]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
