"""Seeded source images and the TIFFs the service reads.

A scan-like image of 1 or 3 components at 8 or 16 bits: smooth
structure, hard edges and sensor noise, as ``chip_smoke.py``'s ``photo``
makes it (in 8-bit RGB), with the phases of the structure drawn from the
seed too; deeper samples scale it to their range. It is made on the device in a few
large calls with a ``torch.Generator`` (so a 67 MPix map costs no host
time to speak of) and brought to the host once. Every seed gives images
of the same statistics, so the coded bytes and the work per image do
not move with the seed.
"""
from __future__ import annotations

import struct

import numpy as np
import torch


def seed_of(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for ``seed`` and a stream number."""
    ss = np.random.SeedSequence([seed % (1 << 64), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def scan(seed: int, index: int, h: int, w: int, device,
         components: int = 3, bitdepth: int = 8) -> np.ndarray:
    """Image ``index`` of ``seed``: (h, w, components) on the host,
    uint8 up to 8 bits, uint16 above."""
    scale = float(1 << (bitdepth - 8)) if bitdepth > 8 else 1.0
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 1, index))
    phase = torch.rand(3, generator=gen, device=device) * 6.2831853
    y = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    x = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    base = (0.45 + 0.2 * torch.sin(x / 97.0 + phase[0])
            * torch.cos(y / 61.0 + phase[1])
            + 0.15 * torch.sign(torch.sin(x / 413.0 + y / 251.0
                                          + phase[2])))
    noise = torch.randn((components, h, w), generator=gen,
                        device=device) * (5.0 * scale)
    gain = torch.tensor([200.0, 220.0, 240.0][:components],
                        device=device)[:, None, None] * scale
    img = torch.clamp(base[None] * gain + noise, 0, (1 << bitdepth) - 1)
    if bitdepth <= 8:
        return img.to(torch.uint8).permute(1, 2, 0).contiguous().cpu() \
            .numpy()
    return img.to(torch.int32).permute(1, 2, 0).contiguous().cpu() \
        .numpy().astype(np.uint16)


def write_tiff(path: str, img: np.ndarray) -> None:
    """Uncompressed baseline TIFF of an (h, w, 1 or 3) uint8 or uint16
    image, one strip, little-endian."""
    h, w, comps = img.shape
    bits = img.dtype.itemsize * 8
    data = np.ascontiguousarray(img.astype(img.dtype.newbyteorder("<"))) \
        .tobytes()
    n_tags = 10
    ifd_at = 8
    bps_at = ifd_at + 2 + 12 * n_tags + 4
    data_at = bps_at + 2 * comps
    tags = [(256, 4, 1, w), (257, 4, 1, h),
            (258, 3, comps, bps_at if comps > 1 else bits),
            (259, 3, 1, 1), (262, 3, 1, 2 if comps == 3 else 1),
            (273, 4, 1, data_at), (277, 3, 1, comps), (278, 4, 1, h),
            (279, 4, 1, len(data)), (284, 3, 1, 1)]
    with open(path, "wb") as fh:
        fh.write(b"II*\0" + struct.pack("<I", ifd_at))
        fh.write(struct.pack("<H", n_tags))
        for tag, typ, count, value in tags:
            packed = (struct.pack("<HH", value, 0) if typ == 3 and count == 1
                      else struct.pack("<I", value))
            fh.write(struct.pack("<HHI", tag, typ, count) + packed)
        fh.write(struct.pack("<I", 0))
        fh.write(struct.pack(f"<{comps}H", *[bits] * comps))
        fh.write(data)
