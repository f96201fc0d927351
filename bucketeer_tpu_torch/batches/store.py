"""``BTB1`` — the stored batch container.

One self-describing blob per assembled batch: a JSON header (recipe
echo, per-item manifest, band directory) followed by one ``BTT1``
tensor container per subband, in band order. Riding BTT1 buys the
progressive half for free: ``truncate_batch(blob, planes=k)`` cuts
every band's bit-plane payload at the same absolute depth without
re-coding — "RD-Optimized Trit-Plane Coding" (PAPERS.md) is the
playbook — so ``GET /batches/{id}?planes=k`` serves cheap low-fidelity
batches first and refines by re-reading deeper.

Each band is coded by the tensor codec on the device type its batch
lies on: a batch on the card launches ``fused_t1`` there, a CPU batch
runs its plain version. The bytes do not depend on the device.

Structural corruption (truncated buffer, flipped magic, mangled JSON,
a band directory overrunning the payload) raises the typed
:class:`DecodeError`, never a bare ``struct.error``/``KeyError`` —
the same fuzz contract the image and tensor decoders carry.
"""
from __future__ import annotations

import json
import struct

import numpy as np

from ..codec.decode.errors import DecodeError
from ..tensor import decode_tensor, encode_tensor, truncate_tensor
from ..tensor.codec import tensor_stats

MAGIC = b"BTB1"
VERSION = 1
_HEADER_CAP = 1 << 24       # sanity bound on the JSON header length


def _band_key(entry: dict) -> tuple:
    return (int(entry["res"]), str(entry["name"]))


def encode_batch(result, planes: int | None = None) -> bytes:
    """Serialize a :class:`BatchResult` (host-materializing via its
    ``to_host`` seam), coding each band on the device type of the
    result's bands. ``planes=k`` floors every band at encode time — the
    dropped planes cost no coding work."""
    host = result.to_host()
    directory, payload = [], []
    for key in sorted(host, key=lambda k: (k[0], k[1])):
        blob = encode_tensor(np.ascontiguousarray(host[key]),
                             planes=planes, torch_device=result.device)
        directory.append({"res": key[0], "name": key[1],
                          "nbytes": len(blob)})
        payload.append(blob)
    header = {
        "version": VERSION,
        "ids": list(result.ids),
        "layout": result.layout,
        "meta": dict(result.meta),
        "manifest": list(result.manifest),
        "deltas": [[k[0], k[1], float(v)]
                   for k, v in sorted(result.deltas.items())],
        "bands": directory,
    }
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return b"".join([MAGIC, struct.pack(">BI", VERSION, len(hdr)),
                     hdr, *payload])


def _parse(blob: bytes):
    """(header dict, [(key, band blob)]) or typed DecodeError."""
    try:
        if len(blob) < 9 or blob[:4] != MAGIC:
            raise DecodeError("not a BTB1 batch container")
        version, hlen = struct.unpack_from(">BI", blob, 4)
        if version != VERSION:
            raise DecodeError(f"unsupported BTB1 version {version}")
        if hlen > _HEADER_CAP or 9 + hlen > len(blob):
            raise DecodeError("BTB1 header overruns the container")
        header = json.loads(blob[9:9 + hlen].decode("utf-8"))
        bands = header["bands"]
        if not isinstance(bands, list) or not bands:
            raise DecodeError("BTB1 header lists no bands")
        off = 9 + hlen
        out = []
        for entry in bands:
            nbytes = int(entry["nbytes"])
            if nbytes < 0 or off + nbytes > len(blob):
                raise DecodeError(
                    "BTB1 band directory overruns the payload")
            out.append((_band_key(entry), blob[off:off + nbytes]))
            off += nbytes
        return header, out
    except DecodeError:
        raise
    except (struct.error, ValueError, KeyError, TypeError,
            UnicodeDecodeError) as exc:
        raise DecodeError(f"malformed BTB1 container: {exc}") from exc


def decode_batch(blob: bytes, planes: int | None = None):
    """Decode a stored batch back to host arrays:
    ``(header, {(res, name): (N, C, H_b, W_b) ndarray})``. ``planes=k``
    is an on-the-fly cut — missing planes reconstruct at the BTT1
    midpoint rule, same as :func:`tensor.decode_tensor`."""
    header, bands = _parse(bytes(blob))
    return header, {key: decode_tensor(b, planes=planes)
                    for key, b in bands}


def truncate_batch(blob: bytes, planes: int) -> bytes:
    """Progressively truncate every band of a stored batch at the same
    absolute plane depth, re-emitting a valid (smaller) BTB1 blob —
    no re-coding, just the per-band BTT1 plane cut."""
    header, bands = _parse(bytes(blob))
    directory, payload = [], []
    for key, b in bands:
        cut = truncate_tensor(b, planes=planes)
        directory.append({"res": key[0], "name": key[1],
                          "nbytes": len(cut)})
        payload.append(cut)
    header = dict(header)
    header["bands"] = directory
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return b"".join([MAGIC, struct.pack(">BI", VERSION, len(hdr)),
                     hdr, *payload])


def batch_stats(blob: bytes) -> dict:
    """Cheap container metadata for the HTTP layer (no Tier-1 work):
    the manifest plus per-band coded sizes."""
    header, bands = _parse(bytes(blob))
    per_band = {}
    for key, b in bands:
        st = tensor_stats(b)
        per_band[f"{key[0]}:{key[1]}"] = {
            "coded_bytes": st["coded_bytes"],
            "shape": st["shape"], "dtype": st["dtype"]}
    return {"ids": header.get("ids", []),
            "layout": header.get("layout"),
            "meta": header.get("meta", {}),
            "manifest": header.get("manifest", []),
            "n_bands": len(bands),
            "coded_bytes": len(blob),
            "bands": per_band}
