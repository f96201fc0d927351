"""Fused EBCOT Tier-1 for one launch group of 64x64 code-blocks: the
CX/D context-modeling scan chained straight into the MQ arithmetic
coder.

:func:`fused_t1` computes what the TPU kernel ``fused_pallas``
(bucketeer_tpu/codec/pallas/fused_t1.py) computes, with the same inputs
and outputs: (N, 64, 64) int32 blocks plus per-block meta in; byte rows,
per-pass byte snapshots, data lengths, per-pass distortion pairs and
symbol/byte cursors out. On a CUDA tensor it launches the hand-written
Hopper kernel in ``csrc/fused_t1.cu``; on a CPU tensor it runs
:func:`fused_t1_plain`, the same function in plain PyTorch. Nothing
falls back from one to the other.

The plain version is :func:`cxd_scan_plain` chained into
:func:`mq_scan_plain`; its distortion pairs are the canonical ones
described in kernels/cxd_scan.py.
"""
from __future__ import annotations

import torch

from .build import kernel_library, launch
from .cxd_scan import (CBLK, check_group, cxd_scan_plain, declared_work,
                       max_syms, tables)
from .mq_scan import MQ_ROW_BYTES, mq_capacity, mq_scan_plain

__all__ = ["CBLK", "MQ_ROW_BYTES", "KERNEL", "fused_t1", "fused_t1_plain",
           "max_syms", "mq_capacity", "tables", "work"]


def fused_t1_plain(L: int, frac: int, blocks, nbps, floors, cls, hs, ws):
    """The fused Tier-1 in plain PyTorch: the plain CX/D scan chained
    into the plain MQ coder (the TPU reference's jnp composition
    ``_cxd_single`` + ``_mq_run_while``). Same signature and outputs as
    :func:`fused_t1`."""
    buf, counts, dh, dl, cur = cxd_scan_plain(L, frac, blocks, nbps,
                                              floors, cls, hs, ws)
    msym = max_syms(L)
    flags = (nbps > floors).to(torch.int32)
    rows, snaps, dlen, curb = mq_scan_plain(L, msym, mq_capacity(msym),
                                            buf, counts, cur, flags)
    return (rows.reshape(-1, MQ_ROW_BYTES), snaps, dlen, dh, dl, cur,
            curb)


# --- the CUDA kernel ---------------------------------------------------

KERNEL = kernel_library("fused_t1", ("fused_t1.cu", "t1_common.cuh"),
                        10, 4, 7, occupancy=True)


def fused_t1(L: int, frac: int, blocks, nbps, floors, cls, hs, ws):
    """Fused Tier-1 for one launch group: (N, 64, 64) int32 blocks and
    (N,) int32 nbps/floors/cls/hs/ws at plane budget ``L`` and
    fixed-point shift ``frac`` -> (byte rows (N*cap/512, 512) uint8,
    snaps (N, L, 3) int32, dlen (N,) int32, dh/dl (N, L, 3) float32,
    symbol cursors (N,) int32, byte cursors (N,) int32), with
    cap = mq_capacity(max_syms(L)). Each block's segment starts with
    the coder's dummy pre-byte; bytes past its byte cursor mean
    nothing.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if blocks.device.type == "cpu":
        return fused_t1_plain(L, frac, blocks, nbps, floors, cls, hs, ws)
    if blocks.device.type != "cuda":
        raise ValueError(f"fused_t1: no implementation for device "
                         f"{blocks.device}")
    check_group("fused_t1", blocks, nbps, floors, cls, hs, ws)
    dev = blocks.device
    n = blocks.shape[0]
    cap = mq_capacity(max_syms(L))
    # The kernel writes every output except the bytes past each block's
    # byte cursor, which carry no meaning.
    rows = torch.empty((n, cap), dtype=torch.uint8, device=dev)
    snaps = torch.empty((n, L, 3), dtype=torch.int32, device=dev)
    dlen = torch.empty(n, dtype=torch.int32, device=dev)
    dh = torch.empty((n, L, 3), dtype=torch.float32, device=dev)
    dl = torch.empty((n, L, 3), dtype=torch.float32, device=dev)
    cur = torch.empty(n, dtype=torch.int32, device=dev)
    curb = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        tabs = tables(dev)
        launch(KERNEL, (blocks.data_ptr(), nbps.data_ptr(),
                        floors.data_ptr(), cls.data_ptr(), hs.data_ptr(),
                        ws.data_ptr(), tabs["zc"].data_ptr(),
                        tabs["sc_ctx"].data_ptr(), tabs["sc_xor"].data_ptr(),
                        tabs["qe"].data_ptr(), n, L, int(frac), cap,
                        rows.data_ptr(), snaps.data_ptr(), dlen.data_ptr(),
                        dh.data_ptr(), dl.data_ptr(), cur.data_ptr(),
                        curb.data_ptr()), dev)
    return (rows.reshape(-1, MQ_ROW_BYTES), snaps, dlen, dh, dl, cur,
            curb)


def work(L: int, args, out):
    """The least work of one launch, as ``analysis.graftcost.CostFacts``
    (a ctypes launch is invisible to the dispatch recorder, so the
    wrapper declares it): each input byte read once (a block's h x w
    extent, not its 64x64 slot, and its 5 meta words), each meaningful
    output byte written once (the coded bytes with the dummy pre-byte;
    snaps, dh, dl; dlen and both cursors), one operation per coded
    decision, and the decisions of the longest block as the serial
    chain. ``args`` are the wrapper's (blocks, nbps, floors, cls, hs,
    ws), ``out`` its seven outputs; only hs, ws, dlen and the symbol
    cursors are read."""
    hs, ws = args[4], args[5]
    dlen, cur = out[2], out[5]
    n = hs.shape[0]
    coded = int((dlen.to(torch.int64) + 1).sum()) if n else 0
    return declared_work("fused_t1", L, hs, ws, cur,
                         (coded, n * L * 3 * 4, n * L * 3 * 4,
                          n * L * 3 * 4, n * 4, n * 4, n * 4))
