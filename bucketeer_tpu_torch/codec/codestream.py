"""JPEG 2000 codestream assembly: markers and segments (T.800 Annex A).

Produces the raw .j2k codestream (SOC..EOC) that jp2.py wraps in JP2/JPX
boxes — the byte-level contract that lets any conforming decoder
(OpenJPEG, Kakadu, browsers) read what the TPU encoded. Mirrors the
structural options of the reference's Kakadu recipe
(reference: converters/KakaduConverter.java:38-44).
"""
from __future__ import annotations

import struct

SOC = 0xFF4F
SIZ = 0xFF51
COD = 0xFF52
COC = 0xFF53
QCD = 0xFF5C
QCC = 0xFF5D
COM = 0xFF64
SOT = 0xFF90
SOD = 0xFF93
EOC = 0xFFD9
PLT = 0xFF58

PROG_LRCP = 0
PROG_RLCP = 1
PROG_RPCL = 2
PROG_PCRL = 3
PROG_CPRL = 4


def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def siz(width: int, height: int, n_comps: int, bitdepth: int,
        tile_w: int, tile_h: int, signed: bool = False) -> bytes:
    ssiz = (bitdepth - 1) | (0x80 if signed else 0)
    payload = struct.pack(">HIIIIIIIIH", 0, width, height, 0, 0,
                          tile_w, tile_h, 0, 0, n_comps)
    payload += bytes([ssiz, 1, 1]) * n_comps
    return _seg(SIZ, payload)


def cod(progression: int, n_layers: int, use_mct: bool, levels: int,
        cblk_w_exp: int = 6, cblk_h_exp: int = 6, reversible: bool = False,
        precinct_exps=None, use_sop: bool = False, use_eph: bool = False) -> bytes:
    scod = ((1 if precinct_exps else 0)
            | (2 if use_sop else 0)
            | (4 if use_eph else 0))
    payload = bytes([scod]) + struct.pack(">BHB", progression, n_layers,
                                          1 if use_mct else 0)
    payload += bytes([levels, cblk_w_exp - 2, cblk_h_exp - 2, 0,
                      1 if reversible else 0])
    if precinct_exps:
        # One byte per resolution 0..levels: PPx | PPy<<4
        payload += bytes([(px & 0xF) | ((py & 0xF) << 4)
                          for px, py in precinct_exps])
    return _seg(COD, payload)


def qcd(style: int, guard_bits: int, subband_values: list) -> bytes:
    """style 0: no quantization, values = exponents (one byte eps<<3).
    style 2: scalar expounded, values = (eps, mu) pairs (two bytes)."""
    sqcd = style | (guard_bits << 5)
    payload = bytes([sqcd])
    if style == 0:
        payload += bytes([(eps & 0x1F) << 3 for eps in subband_values])
    else:
        for eps, mu in subband_values:
            payload += struct.pack(">H", ((eps & 0x1F) << 11) | (mu & 0x7FF))
    return _seg(QCD, payload)


def com(text: str) -> bytes:
    return _seg(COM, struct.pack(">H", 1) + text.encode("latin-1"))


def sot(tile_idx: int, tile_part_len: int, tpsot: int = 0, tnsot: int = 1) -> bytes:
    return _seg(SOT, struct.pack(">HIBB", tile_idx, tile_part_len, tpsot, tnsot))


def plt(packet_lengths: list, zplt: int = 0) -> bytes:
    """Packet-length marker (A.7.3), 7-bit big-endian varints."""
    payload = bytes([zplt])
    out = bytearray(payload)
    for ln in packet_lengths:
        enc = []
        enc.append(ln & 0x7F)
        ln >>= 7
        while ln:
            enc.append(0x80 | (ln & 0x7F))
            ln >>= 7
        out += bytes(reversed(enc))
    return _seg(PLT, bytes(out))


def assemble(main_segments: list, tiles: list) -> bytes:
    """tiles: list of (tile_idx, [aux_segments], packet_bytes) — one
    tile-part per tile."""
    return assemble_parts(main_segments, [
        (tile_idx, 0, 1, aux, packets)
        for tile_idx, aux, packets in tiles])


def assemble_parts(main_segments: list, tileparts: list) -> bytes:
    """Multi-tile-part assembly (reference recipe ``ORGtparts=R`` splits
    each tile at resolution boundaries, KakaduConverter.java:40).

    tileparts: list of (tile_idx, tpsot, tnsot, [aux_segments],
    packet_bytes) in codestream order.
    """
    out = bytearray(struct.pack(">H", SOC))
    for seg in main_segments:
        out += seg
    for tile_idx, tpsot, tnsot, aux, packets in tileparts:
        aux_len = sum(len(a) for a in aux)
        psot = 12 + aux_len + 2 + len(packets)
        out += sot(tile_idx, psot, tpsot, tnsot)
        for a in aux:
            out += a
        out += struct.pack(">H", SOD)
        out += packets
    out += struct.pack(">H", EOC)
    return bytes(out)
