"""The general bit-plane tensor codec: arbitrary int/float tensors
through the image pipeline's own Tier-1 kernels.

``encode_tensor`` maps a tensor to 16-bit signed limb planes
(tensor/planes.py), carves them into the same 64x64 code-blocks the
image front-end uses, and routes them through the fused CX/D + MQ
Tier-1 kernel on the card (codec/cxd.py ``run_device_mq``,
``csrc/fused_t1.cu``) — the host never touches a symbol; it assembles
finished byte segments into the self-describing ``BTT1`` container
(tensor/container.py). Checkpoint and activation tensors become
progressive bit-plane streams truncatable at any plane boundary.

Three backends share one output, byte for byte:

- ``device`` (default): the fused kernel (cxd.run_device_mq);
- ``replay``: the CX/D scan kernel, then the host MQ replay
  (cxd.run_cxd + t1_batch.encode_cxd);
- ``host``: the pure-host reference coder (t1.encode_block), no card at
  all — the oracle the other two are held against.

The two card backends run on ``torch_device`` ("cuda" unless the caller
asks for "cpu", where every kernel runs its plain PyTorch version; a
card asked for without CUDA raises). The limb mapping and the block
rows stay on the host; each chunk of rows goes to the device once, is
reshaped into (N, 64, 64) blocks there, and only the per-block
magnitude maxima come back before the Tier-1 launch.

Decoding is host Tier-1 (codec/decode/t1_dec.py — the MQ state machine
is inherently serial), then the inverse plane mapping. Lossless for
every supported dtype, including IEEE NaN payloads and negative zeros
(an explicit escape list; see tensor/planes.py).

Rate control: every block's plane-boundary truncation points (the
``rate.truncation_lengths`` rule, bytes-at-boundary + 4 capped at the
stream) are recorded in the container, so :func:`truncate_tensor` cuts
an existing blob to ``planes=`` (keep the top-k absolute payload
planes) or ``rate=`` (byte budget, deepest global plane cut that fits)
by pure byte slicing — no recode. ``encode_tensor(planes=k)`` instead
floors the planes at encode time, so the skipped planes cost no coding
work at all.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..codec import cxd as cxd_mod
from ..codec import t1, t1_batch
from ..codec.decode import t1_dec
from ..codec.decode.device import require_device
from ..codec.decode.errors import DecodeError
from . import container
from . import planes as _planes

BLOCK = 64
BLOCK_SAMPLES = container.BLOCK_SAMPLES

# Blocks per device chunk: bounds the device symbol buffer
# (N x max_syms(16) ~ 100 KB/block on the replay backend).
DEFAULT_CHUNK_BLOCKS = 64

# Every tensor block codes with the LL context tables: there is no
# subband orientation to exploit in a generic tensor, and one fixed
# class keeps device and host paths trivially in agreement.
BAND = "LL"

_metrics_sink = None


def set_metrics_sink(sink) -> None:
    """Install a metrics sink with ``record``/``count``; None
    disables."""
    global _metrics_sink
    _metrics_sink = sink


_services = threading.local()


@contextlib.contextmanager
def tensor_services(check=None, launch=None):
    """Per-thread scheduler services — the tensor-codec mirror of the
    decoder's services. ``check`` is the deadline hook polled between
    chunks/blocks; ``launch`` (``callable(rows, floors, backend, device)
    -> (blocks, n_syms, device_seconds)``, ``device`` the torch.device
    the caller asked for) routes device-backend chunks through a
    scheduler's device pool so compatible chunks from concurrent tensor
    jobs can merge into one launch."""
    prev = (getattr(_services, "check", None),
            getattr(_services, "launch", None))
    _services.check = check
    _services.launch = launch
    try:
        yield
    finally:
        _services.check, _services.launch = prev


def _poll() -> None:
    check = getattr(_services, "check", None)
    if check is not None:
        check()


# --- encode ---------------------------------------------------------------

def _resolve_backend(device) -> str:
    if device not in ("device", "replay", "host"):
        raise ValueError(
            f"unknown tensor backend {device!r}: expected device | "
            "replay | host")
    return device


def _block_rows(limbs: np.ndarray) -> np.ndarray:
    """(K, n) limb planes -> (K * nb, 4096) int32 block rows,
    limb-major, tails zero-padded (zeros never become significant, so
    padding costs no symbols)."""
    k, n = limbs.shape
    nb = -(-n // BLOCK_SAMPLES) if n else 0
    rows = np.zeros((k, nb * BLOCK_SAMPLES), dtype=np.int32)
    rows[:, :n] = limbs
    return rows.reshape(k * nb, BLOCK_SAMPLES)


def _limb_bases(k: int, nb: int) -> np.ndarray:
    """Absolute payload-plane base of every block (limb-major order):
    limb j covers planes [(K-1-j)*16, (K-j)*16)."""
    return np.repeat(
        np.array([(k - 1 - j) * _planes.LIMB_BITS for j in range(k)],
                 dtype=np.int32), nb)


def _encode_host(rows: np.ndarray, floors: np.ndarray) -> list:
    out = []
    for row, floor in zip(rows, floors):
        _poll()
        block = row.reshape(BLOCK, BLOCK)
        mags = (np.abs(block).astype(np.uint32) >> floor) << floor
        out.append(t1.encode_block(mags, block < 0, BAND,
                                   floor=int(floor)))
    return out


def pack_blocks(rows: np.ndarray, device) -> tuple:
    """The block packer: a chunk's (N, 4096) int32 host rows to the
    (N, 64, 64) block batch on ``device`` (one host-to-device copy; the
    blocks stay there for the Tier-1 launch) and the (N,) per-block
    magnitude maxima, on ``device`` too (:func:`fetch_block_meta`
    brings them over)."""
    blocks = torch.from_numpy(np.ascontiguousarray(rows)).to(
        device).reshape(-1, BLOCK, BLOCK)
    return blocks, blocks.abs().amax((1, 2))


def fetch_block_meta(maxmag: torch.Tensor) -> np.ndarray:
    """The pack stage's one device-to-host transfer: the (N,) per-block
    magnitude maxima (4 bytes a block; the blocks stay on the device for
    the Tier-1 launch). Sanctioned in rules_torch.D2H_SANCTIONED."""
    return maxmag.cpu().numpy()


def _coded_planes(maxmag: np.ndarray) -> np.ndarray:
    """(N,) int32 coded plane counts from the host magnitude maxima."""
    nbps = np.zeros(len(maxmag), dtype=np.int32)
    nz = maxmag > 0
    nbps[nz] = np.floor(np.log2(maxmag[nz].astype(np.float64))).astype(
        np.int32) + 1
    return nbps


def encode_chunk_device(rows: np.ndarray, floors: np.ndarray,
                        backend: str, device="cuda"):
    """One chunk through the card backends on ``device``: pack -> fused
    Tier-1 (``backend="device"``) or pack -> CX/D scan -> host MQ replay
    (``"replay"``). Returns ([t1.CodedBlock], symbols, device_seconds),
    the device seconds on the host clock from the copy in to the last
    fetch (each ends in a ``.cpu()``)."""
    if backend not in ("device", "replay"):
        raise ValueError(f"encode_chunk_device: backend {backend!r} is "
                         "not a card backend (device | replay)")
    device = require_device(device)
    t0 = time.perf_counter()
    blocks, maxmag = pack_blocks(rows, device)
    nbps = _coded_planes(fetch_block_meta(maxmag))
    n = len(nbps)
    hs = np.full(n, BLOCK, dtype=np.int32)
    bandnames = [BAND] * n
    if backend == "device":
        res = cxd_mod.run_device_mq(blocks, nbps, floors, bandnames, hs,
                                    hs, 0)
        return (res.cols.blocks(_metrics_sink), res.total_syms,
                time.perf_counter() - t0)
    streams = cxd_mod.run_cxd(blocks, nbps, floors, bandnames, hs, hs, 0)
    dev_s = time.perf_counter() - t0
    return t1_batch.encode_cxd(streams), streams.total_syms, dev_s


def _to_tensor_block(blk: t1.CodedBlock) -> container.TensorBlock:
    cums = np.asarray([p.cum_length for p in blk.passes
                       if p.pass_type == 2], dtype=np.int64)
    return container.TensorBlock(blk.n_bitplanes, len(cums), blk.data,
                                 cums)


def encode_tensor(arr, planes: int | None = None,
                  rate: int | None = None, device: str = "device",
                  chunk_blocks: int | None = None,
                  torch_device="cuda") -> bytes:
    """Encode a tensor (numpy array or torch tensor on any device) to
    ``BTT1`` container bytes.

    ``planes=k`` keeps only the top ``k`` absolute payload planes
    (encode-time floors: the dropped planes cost no coding work);
    ``rate=b`` encodes losslessly and then truncates the blob to the
    deepest global plane cut fitting ``b`` bytes. ``device`` picks the
    backend (``device`` | ``replay`` | ``host``) — all three are
    byte-identical. ``torch_device`` is where the two
    card backends run ("cuda", or "cpu" for their plain versions);
    "cuda" without CUDA raises. ``chunk_blocks`` (default
    DEFAULT_CHUNK_BLOCKS) blocks go to the device per chunk; the bytes
    do not depend on it.
    """
    # The limb rows are made on the host: a tensor on the card comes
    # over once.
    arr = (_planes.fetch_tensor(arr) if isinstance(arr, torch.Tensor)
           else np.asarray(arr))
    spec = _planes.spec_for(arr.dtype)
    t_wall = time.perf_counter()
    backend = _resolve_backend(device)
    if backend != "host":
        torch_device = require_device(torch_device)
    limbs = _planes.to_limbs(arr)
    negz = _planes.negative_zero_positions(arr, spec)
    rows = _block_rows(limbs)
    k = spec.n_limbs
    nb = len(rows) // k if k else 0
    total_bits = k * _planes.LIMB_BITS
    bases = _limb_bases(k, nb)
    if planes is not None:
        if planes < 0:
            raise ValueError(f"planes must be >= 0, got {planes}")
        cut = max(0, total_bits - int(planes))
    else:
        cut = 0
    floors = np.clip(cut - bases, 0, _planes.LIMB_BITS).astype(np.int32)

    coded: list = []
    n_syms = 0
    dev_s = 0.0
    chunk = DEFAULT_CHUNK_BLOCKS if chunk_blocks is None else max(
        1, int(chunk_blocks))
    launch = getattr(_services, "launch", None)
    for off in range(0, len(rows), chunk):
        _poll()
        sub = rows[off:off + chunk]
        fsub = floors[off:off + chunk]
        if backend == "host":
            coded += _encode_host(sub, fsub)
        else:
            if backend == "device" and launch is not None:
                # Scheduler seam: the pool runs (and possibly merges)
                # the chunk on a free device; byte-identical because
                # per-block coding is independent of its batch-mates.
                blks, syms, ds = launch(sub, fsub, backend,
                                        torch_device)
            else:
                blks, syms, ds = encode_chunk_device(sub, fsub, backend,
                                                     torch_device)
            coded += blks
            n_syms += syms
            dev_s += ds

    enc = container.EncodedTensor(
        spec, tuple(arr.shape), negz, [_to_tensor_block(b) for b in coded])
    blob = container.dump(enc)
    if _metrics_sink is not None:
        _metrics_sink.record("tensor.encode",
                             time.perf_counter() - t_wall,
                             items=arr.nbytes)
        if dev_s:
            _metrics_sink.record("tensor.encode_device", dev_s,
                                 items=n_syms)
        _metrics_sink.count("tensor.encode_blocks", len(coded))
        _metrics_sink.count("tensor.raw_bytes", arr.nbytes)
        _metrics_sink.count("tensor.coded_bytes", len(blob))
    if rate is not None:
        return truncate_tensor(blob, rate=rate)
    return blob


# --- truncation -----------------------------------------------------------

def _cut_kept(b: container.TensorBlock, base: int, cut: int) -> int:
    """Planes block ``b`` keeps under the absolute payload-plane
    ``cut`` (never more than it already has)."""
    floor_new = max(b.nbp - b.kept, min(cut - base, _planes.LIMB_BITS))
    return max(0, b.nbp - floor_new)


def _container_size(enc: container.EncodedTensor, cut: int,
                    bases: np.ndarray) -> int:
    """Serialized size of ``_apply_cut(enc, cut)`` from the parsed
    headers alone — no byte copies (rate= probes every cut, so this
    must be arithmetic, not a dump)."""
    size = 17 + 8 * len(enc.shape) + 8 * len(enc.neg_zeros)
    for b, base in zip(enc.blocks, bases):
        kept = _cut_kept(b, int(base), cut)
        size += 6 + 4 * kept
        if kept == b.kept:
            size += len(b.data)
        elif kept:
            size += int(b.cums[kept - 1])
    return size


def _apply_cut(enc: container.EncodedTensor,
               cut: int) -> container.EncodedTensor:
    """Truncate every block at the absolute payload-plane ``cut``
    (drop planes below it) by slicing at the recorded plane-boundary
    lengths — no recode."""
    k = enc.spec.n_limbs
    nb = enc.blocks_per_limb
    bases = _limb_bases(k, nb)
    blocks = []
    for b, base in zip(enc.blocks, bases):
        kept = _cut_kept(b, int(base), cut)
        if kept == b.kept:
            blocks.append(b)
        elif kept == 0:
            blocks.append(container.TensorBlock(
                b.nbp, 0, b"", np.zeros(0, dtype=np.int64)))
        else:
            end = int(b.cums[kept - 1])
            blocks.append(container.TensorBlock(
                b.nbp, kept, b.data[:end], b.cums[:kept]))
    return container.EncodedTensor(enc.spec, enc.shape, enc.neg_zeros,
                                   blocks)


def truncate_tensor(blob: bytes, planes: int | None = None,
                    rate: int | None = None) -> bytes:
    """Progressively truncate an encoded tensor at plane boundaries.

    ``planes=k``: keep the top ``k`` absolute payload planes.
    ``rate=b``: the deepest (least destructive) global plane cut whose
    container fits ``b`` bytes; the header itself is the floor — a
    budget below it returns the fully-cut container.
    """
    enc = container.parse(blob)
    total_bits = enc.spec.n_limbs * _planes.LIMB_BITS
    if (planes is None) == (rate is None):
        raise ValueError("pass exactly one of planes= / rate=")
    if planes is not None:
        if planes < 0:
            raise ValueError(f"planes must be >= 0, got {planes}")
        return container.dump(_apply_cut(enc, total_bits - min(
            int(planes), total_bits)))
    if rate < 0:
        raise ValueError(f"rate must be >= 0, got {rate}")
    # Candidate sizes are pure header arithmetic (_container_size);
    # only the winning cut is serialized.
    bases = _limb_bases(enc.spec.n_limbs, enc.blocks_per_limb)
    for cut in range(0, total_bits + 1):
        if _container_size(enc, cut, bases) <= rate:
            break
    else:
        cut = total_bits
    return container.dump(_apply_cut(enc, cut))


# --- decode ---------------------------------------------------------------

def decode_tensor(blob: bytes, planes: int | None = None):
    """Decode ``BTT1`` container bytes back to a tensor: a numpy array
    for every dtype numpy has, a CPU ``torch.bfloat16`` tensor for
    bfloat16. A losslessly coded blob round-trips bit-exact (NaN
    payloads and negative zeros included); a truncated blob (or
    ``planes=k``, an on-the-fly cut) reconstructs missing planes at the
    EBCOT midpoint, floored — the same deterministic rule the image
    decoder's quality layers use. Malformed input raises the typed
    :class:`DecodeError`."""
    if planes is not None and planes < 0:
        raise ValueError(f"planes must be >= 0, got {planes}")
    t_wall = time.perf_counter()
    try:
        enc = container.parse(blob)
        total_bits = enc.spec.n_limbs * _planes.LIMB_BITS
        if planes is not None:
            enc = _apply_cut(enc, total_bits - min(int(planes),
                                                   total_bits))
        k = enc.spec.n_limbs
        nb = enc.blocks_per_limb
        n = enc.n_elements
        limbs = np.zeros((k, nb * BLOCK_SAMPLES), dtype=np.int32)
        n_dec = 0
        for i, b in enumerate(enc.blocks):
            _poll()
            if not (b.kept and b.nbp):
                continue
            hv, nd = t1_dec.decode_block(
                b.data, b.nbp, 3 * b.kept - 2, BAND, BLOCK, BLOCK)
            n_dec += nd
            mag = np.abs(hv) >> 1
            j, bi = divmod(i, nb)
            limbs[j, bi * BLOCK_SAMPLES:(bi + 1) * BLOCK_SAMPLES] = \
                np.where(hv < 0, -mag, mag).ravel()
        out = _planes.from_limbs(limbs[:, :n], enc.spec, enc.shape,
                                 enc.neg_zeros)
    except DecodeError:
        raise
    except (IndexError, KeyError, ValueError, OverflowError) as exc:
        raise DecodeError(f"malformed tensor container: {exc}") from exc
    if _metrics_sink is not None:
        _metrics_sink.record("tensor.decode",
                             time.perf_counter() - t_wall,
                             items=n_dec)
        _metrics_sink.count("tensor.decode_blocks", len(enc.blocks))
    return out


def tensor_stats(blob: bytes) -> dict:
    """Cheap container metadata for the HTTP layer (no Tier-1 work)."""
    enc = container.parse(blob)
    raw = enc.n_elements * enc.spec.itemsize
    coded = len(blob)
    return {
        "dtype": enc.spec.name,
        "shape": list(enc.shape),
        "limbs": enc.spec.n_limbs,
        "blocks": len(enc.blocks),
        "planes": enc.pcap,
        "raw_bytes": raw,
        "coded_bytes": coded,
        "ratio": round(raw / coded, 4) if coded else 0.0,
    }
