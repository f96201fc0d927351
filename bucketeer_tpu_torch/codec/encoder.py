"""Top-level JPEG 2000 encoder on tensors: the counterpart of
bucketeer_tpu/codec/encoder.py for PyTorch and CUDA.

Pipeline: host image array -> [device] level shift + RCT/ICT + tiled
multi-level DWT + quantization, 64x64 code-block carving and per-plane
stats (codec/frontend.py) -> [device] fused EBCOT Tier-1, the CX/D scan
and the MQ coder in one kernel per launch group (codec/cxd.py,
kernels/fused_t1.py) — or, with ``device_mq=False, device_cxd=True``,
the CX/D split: the CX/D scan alone on the device (kernels/cxd_scan.py)
and the MQ replay of its symbols on the host (codec/t1_batch.py) — or,
with ``device_mq=False`` (or unset off a CUDA device: _tier1_mode) and
``device_cxd`` unset or False, the host Tier-1: bit-planes packed on the
device (front-end mode "rows"), the planes each block codes gathered and
copied to the host, and context modeling and MQ coding there in C++
(t1_batch.encode_packed). All three give byte-identical output -> [host]
PCRD-opt layer allocation (codec/rate.py) -> Tier-2 packets with
precincts, any of the five progressions, SOP/EPH/PLT markers and
per-resolution tile-parts -> codestream -> JP2/JPX boxes.

Tiles are grouped by shape and cut into chunks of CHUNK_TILES tiles;
each chunk's front-end and Tier-1 work is queued on the device's stream
and the host waits only where it needs a result (the stats, then the
finished byte segments, symbol streams or packed payload).

A tile grid whose sub-bands straddle the global 64x64 code-block grid
(a tile size divisible by 2^levels but not by 64, e.g. 96 at 2 levels)
cannot be blockified on the device: its planes come back to the host
after the transform, and the host slices its code-blocks against the
global cell grid and codes them (:func:`_legacy_tier1`).

A scheduler (engine/scheduler.py) routes an encode through shared
resources by installing :func:`pipeline_services` around it: the
front-end dispatch goes to its device pool, the host Tier-1 work (the
split's replay, the packed payload's coding) to its shared host pool, the fused Tier-1 stage to its pipeline-stage hook,
and its deadline check is polled at each chunk dispatch. With no
services installed the encoder runs its own private pipeline.

The full structural recipe of the reference's Kakadu invocation
(``Clevels=6 Clayers=6 Cprecincts={256,256},{256,256},{128,128}
Stiles={512,512} Corder=RPCL ORGgen_plt=yes ORGtparts=R Cblk={64,64}
Cuse_sop=yes Cuse_eph=yes``, lossy ``-rate 3``) is available via
:meth:`EncodeParams.kakadu_recipe`.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs
from . import codestream as cs
from . import cxd as cxd_mod
from . import frontend
from . import jp2 as jp2box
from . import rate as rate_mod
from . import t1, t1_batch, t2
from .dwt import synthesis_gains
from .pipeline import TilePlan, make_plan
from .quant import FRAC_BITS, GUARD_BITS, SubbandQuant

CBLK_EXP = 6  # 64x64 code-blocks (reference recipe Cblk={64,64})

CHUNK_TILES = 8     # same-shape tiles per front-end batch
OVERLAP_DEPTH = 2   # queued-but-unresolved chunks
HOST_QUEUE_DEPTH = 2    # unfinished host Tier-1 jobs before back-pressure

# Optional per-stage timing/counter sink (server.metrics.Metrics): the
# device-dispatch and host-coding segments of every encode, its Tier-1
# segments and its rate-control counters.
_metrics_sink = None


def set_metrics_sink(sink) -> None:
    """Install a metrics sink with ``record(stage, seconds, pixels=0,
    items=0)``, ``record_overlap(stage, device_s, host_s, wall_s,
    pixels=0)`` and ``count(name, n=1)`` (server.metrics.Metrics). None
    disables."""
    global _metrics_sink
    _metrics_sink = sink


# --- scheduler seam -------------------------------------------------------
# A scheduler installs its services thread-locally around the encode
# call, so nothing about encode_array's signature or its per-request
# pipeline logic changes.

_SERVICES = threading.local()


@dataclass
class _PipelineServices:
    dispatch: object          # callable(plan, tiles, mode=...) -> pending
    pool: object              # shared executor; NOT shut down per encode
    check: object = None      # callable raising on deadline/cancel
    t1_launch: object = None  # callable(stage_fn, payload) -> stage
                              # result; the scheduler's pipeline-stage
                              # hook for the fused Tier-1 (None = run
                              # inline on this thread)


def current_services() -> _PipelineServices | None:
    return getattr(_SERVICES, "svc", None)


@contextlib.contextmanager
def pipeline_services(dispatch=None, pool=None, check=None,
                      t1_launch=None):
    """Install scheduler-owned pipeline services for encodes running on
    this thread (the scheduler wraps each admitted request in this)."""
    prev = getattr(_SERVICES, "svc", None)
    _SERVICES.svc = _PipelineServices(dispatch, pool, check, t1_launch)
    try:
        yield
    finally:
        _SERVICES.svc = prev


@dataclass
class EncodeParams:
    lossless: bool = True
    levels: int = 5
    tile_size: int | None = None       # None = single tile (whole image)
    base_delta: float = 0.5            # irreversible base step (image domain)
    n_layers: int = 1
    progression: int = cs.PROG_LRCP
    rate: float | None = None          # target bpp for the whole file (lossy)
    precincts: tuple | None = None     # ((w,h),...) highest-resolution first
    use_sop: bool = False
    use_eph: bool = False
    gen_plt: bool = False
    tparts_r: bool = False             # tile-part per resolution (ORGtparts=R)
    mct: str = "auto"                  # multi-component transform: auto|on|off
    comment: str = "bucketeer-tpu jp2 encoder"
    # Tier-1 placement, as in the JAX package (_tier1_mode below).
    # device_mq=True: the fused device Tier-1 (MQ wins over device_cxd).
    # device_mq=None: the fused Tier-1 on a CUDA device, as the JAX
    # package picks it on a TPU; elsewhere as device_mq=False.
    # device_mq=False with device_cxd=True: the CX/D split, device scan
    # and host MQ replay. device_mq=False without device_cxd: the host
    # Tier-1 over bit-planes packed on the device (front-end mode "rows").
    device_cxd: bool | None = None
    device_mq: bool | None = None

    @classmethod
    def kakadu_recipe(cls, lossless: bool,
                      rate: float | None = 3.0) -> "EncodeParams":
        """The reference's exact Kakadu option set
        (converters/KakaduConverter.java:38-44): 6 levels, 6 layers,
        512x512 tiles, RPCL, precincts 256/256/128, SOP+EPH, PLT,
        R tile-parts; lossless = reversible unbounded rate, lossy 3 bpp.
        """
        return cls(lossless=lossless, levels=6, tile_size=512,
                   base_delta=1.0 if lossless else 2.0,
                   n_layers=6, progression=cs.PROG_RPCL,
                   rate=None if lossless else rate,
                   precincts=((256, 256), (256, 256), (128, 128)),
                   use_sop=True, use_eph=True, gen_plt=True, tparts_r=True)


def _ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


def _band_rect(tcx0: int, tcx1: int, tcy0: int, tcy1: int,
               res: int, name: str, levels: int) -> tuple:
    """Global band-coordinate rectangle of a tile-component's subband
    (T.800 eq. B-15, image/tile offsets 0)."""
    if name == "LL":
        k, xob, yob = levels, 0, 0
    else:
        k = levels - res + 1
        xob = 1 if name in ("HL", "HH") else 0
        yob = 1 if name in ("LH", "HH") else 0
    step = 1 << k
    half = 1 << (k - 1)
    bx0 = _ceil_div(tcx0 - half * xob, step)
    bx1 = _ceil_div(tcx1 - half * xob, step)
    by0 = _ceil_div(tcy0 - half * yob, step)
    by1 = _ceil_div(tcy1 - half * yob, step)
    return bx0, bx1, by0, by1


def _precinct_exps(params: EncodeParams, levels: int) -> list:
    """Per-resolution (PPx, PPy) exponents on the resolution grid,
    r=0 (coarsest) first. Kakadu's Cprecincts lists highest resolution
    first with the last entry repeating downward
    (KakaduConverter.java:39)."""
    if not params.precincts:
        return [(15, 15)] * (levels + 1)
    spec = [(int(math.log2(w)), int(math.log2(h)))
            for w, h in params.precincts]
    out = []
    for r in range(levels + 1):
        i = levels - r
        ppx, ppy = spec[i] if i < len(spec) else spec[-1]
        eff = ppx - (1 if r > 0 else 0)
        assert eff >= CBLK_EXP, (
            f"precinct 2^{ppx} at res {r} smaller than the 64x64 "
            "code-block; shrink Cblk or grow the precinct")
        out.append((ppx, ppy))
    return out

# L2 norms of the inverse multi-component transform's columns: a unit
# error in Y/Cb/Cr maps to this much RGB error, so PCRD must scale
# component distortions by norm² or chroma is starved.
_ICT_NORMS = (1.7321, 1.8051, 1.5734)
_RCT_NORMS = (1.7321, 0.8292, 0.8292)


def _rd_at_rate(x2w: np.ndarray, r_target: float,
                lam_fixed: float | None) -> float:
    """Water-filling over per-sample 'coefficient' energies.

    x2w: RGB-domain weighted energies (w_c · x²). At slope λ every
    coded coefficient sits at RGB-domain distortion λ (component
    distortion λ/w_c), coding rate ½log2(x2w/λ). With a rate target,
    bisect λ to hit it and return the total distortion Σ min(x2w, λ);
    with λ fixed (no rate target), return the rate at that slope
    (smaller = cheaper at matched distortion)."""
    l2 = 0.5 * np.log2(x2w)
    if lam_fixed is not None:
        return float(np.maximum(0.0, l2 - 0.5 * math.log2(
            lam_fixed)).sum())
    lo, hi = 1e-9, float(x2w.max()) + 1.0
    for _ in range(50):
        lam = (lo * hi) ** 0.5
        r = float(np.maximum(0.0, l2 - 0.5 * math.log2(lam)).sum())
        if r > r_target:
            lo = lam
        else:
            hi = lam
    lam = (lo * hi) ** 0.5
    return float(np.minimum(x2w, lam).sum())


def _mct_helps(img: np.ndarray, lossless: bool,
               rate: float | None = None,
               base_delta: float = 0.5) -> bool:
    """Per-image, per-rate choice of the multi-component transform.

    The ICT/RCT only pays when the channels correlate *at the operating
    point*: correlated structure favors it, but channel-independent
    fine detail (sensor noise, false color) makes per-channel coding
    cheaper — and which effect wins depends on the target rate (at high
    rates the independent residue dominates the marginal bit). So model
    both bases with water-filling R-D over high-frequency (gradient)
    samples — weighted by the squared inverse-transform column norms
    that map component error to RGB error — and pick the basis with
    less distortion at the target rate (or less rate at the quantizer
    floor when uncapped). kdu_compress applies the ICT unconditionally
    (reference: converters/KakaduConverter.java:38-44, no Cycc=no), so
    this choice matches it on photographs and beats it on
    channel-independent content.
    """
    h, w = img.shape[:2]
    step = max(1, max(h, w) // 256)
    a = img[::step, ::step].astype(np.float32)
    g = np.concatenate([np.diff(a, axis=1).reshape(-1, 3),
                        np.diff(a, axis=0).reshape(-1, 3)])
    if g.shape[0] > 65536:        # bound the host cost of the decision
        g = g[:: g.shape[0] // 65536 + 1]
    n = g.shape[0]
    if n < 16:
        return True
    r, gg, b = g[:, 0], g[:, 1], g[:, 2]
    if lossless:
        comps = ((r + 2 * gg + b) / 4.0, b - gg, r - gg)
        norms2 = [m * m for m in _RCT_NORMS]
    else:
        comps = (0.299 * r + 0.587 * gg + 0.114 * b,
                 -0.16875 * r - 0.33126 * gg + 0.5 * b,
                 0.5 * r - 0.41869 * gg - 0.08131 * b)
        norms2 = [m * m for m in _ICT_NORMS]

    eps = 1e-4
    x2w_rgb = (g * g).reshape(-1) + eps
    x2w_ycc = np.concatenate([w * (c * c) + eps
                              for c, w in zip(comps, norms2)])

    if rate is not None:
        # Total bit budget for the sampled pixels (rate is bpp over all
        # components); lower distortion at that budget wins.
        r_target = rate * n
        return _rd_at_rate(x2w_ycc, r_target, None) < _rd_at_rate(
            x2w_rgb, r_target, None)
    # No rate cap: compare rate at the quantizer floor.
    lam = max((1.0 if lossless else base_delta) ** 2 / 12.0, 1e-6)
    return _rd_at_rate(x2w_ycc, 0.0, lam) < _rd_at_rate(
        x2w_rgb, 0.0, lam)


@dataclass
class _Band:
    name: str
    res: int
    comp: int
    q: SubbandQuant
    bx0: int
    bx1: int
    by0: int
    by1: int
    mags: np.ndarray | None
    signs: np.ndarray | None
    fracs: np.ndarray | None
    blocks: dict = field(default_factory=dict)  # (cy, cx) -> t1.CodedBlock

    @property
    def cell_range(self):
        """Global 64-grid cell index ranges [cx0, cx1) x [cy0, cy1)."""
        if self.bx1 <= self.bx0 or self.by1 <= self.by0:
            return 0, 0, 0, 0
        return (self.bx0 >> CBLK_EXP, ((self.bx1 - 1) >> CBLK_EXP) + 1,
                self.by0 >> CBLK_EXP, ((self.by1 - 1) >> CBLK_EXP) + 1)


def _grid_aligned(plan: TilePlan, origin: tuple) -> str:
    """Classify a tile at ``origin`` for the Tier-1 path choice:

    - ``"ok"``: every sub-band block lands on the global 64-grid exactly
      where the device front-end's band-local blockification puts it (no
      global cell boundary cuts a band's interior) — the packed device
      path applies. Holds for power-of-two tile grids.
    - ``"straddle"``: band geometry matches the local Mallat layout but a
      global 64-grid cell boundary cuts a band's interior (e.g. tile 96
      at 2 levels) — the host Tier-1 path (_legacy_tier1) slices blocks
      against the global cell grid instead.
    - ``"mismatch"``: the tile's *global* band rectangle disagrees with
      the local Mallat geometry (tile size not divisible by 2^levels,
      e.g. tile 50 at 2 levels: global LL height 12 vs local 13). No
      path can code such a tile.
    """
    y0, x0 = origin
    tcx1, tcy1 = x0 + plan.tile_w, y0 + plan.tile_h
    cb = 1 << CBLK_EXP
    state = "ok"
    for slot in plan.slots:
        bx0, bx1, by0, by1 = _band_rect(x0, tcx1, y0, tcy1,
                                        slot.resolution, slot.name,
                                        plan.levels)
        if (by1 - by0, bx1 - bx0) != (slot.h, slot.w):
            return "mismatch"
        if by0 % cb and (by0 % cb) + slot.h > cb:
            state = "straddle"
        if bx0 % cb and (bx0 % cb) + slot.w > cb:
            state = "straddle"
    return state


def _collect_blocks(band: _Band, specs: list, dests: list) -> None:
    """Queue a band's code-blocks (global 64-grid cells intersecting the
    tile-band rect, T.800 B.7) into the host Tier-1 batch — the path
    for tile grids the device front-end cannot blockify."""
    cx0, cx1, cy0, cy1 = band.cell_range
    for cy in range(cy0, cy1):
        for cx in range(cx0, cx1):
            gy0 = max(cy << CBLK_EXP, band.by0)
            gy1 = min((cy + 1) << CBLK_EXP, band.by1)
            gx0 = max(cx << CBLK_EXP, band.bx0)
            gx1 = min((cx + 1) << CBLK_EXP, band.bx1)
            ly0, lx0 = gy0 - band.by0, gx0 - band.bx0
            sl = (slice(ly0, ly0 + gy1 - gy0), slice(lx0, lx0 + gx1 - gx0))
            specs.append((band.mags[sl], band.signs[sl], band.name,
                          None if band.fracs is None else band.fracs[sl]))
            dests.append((band, cy, cx))


def _tile_bands(plan: TilePlan, origin: tuple):
    """Band geometry for one tile in global coordinates.

    Returns (comp_res, band_of_slot): comp_res is the
    [component][resolution] band-list structure Tier-2 walks;
    band_of_slot maps (comp, slot_index) to its _Band so the device
    front-end's canonical block order (frontend.layout_for) can be
    joined to Tier-2's cells. Also asserts that the tile origin puts
    every code-block on the global 64-grid exactly where the device's
    local-grid blockification put it."""
    y0, x0 = origin
    tcx1, tcy1 = x0 + plan.tile_w, y0 + plan.tile_h
    comp_res = []
    band_of_slot = {}
    for c in range(plan.n_comps):
        resolutions = [[] for _ in range(plan.levels + 1)]
        for si, slot in enumerate(plan.slots):
            bx0, bx1, by0, by1 = _band_rect(
                x0, tcx1, y0, tcy1, slot.resolution, slot.name,
                plan.levels)
            assert (by1 - by0, bx1 - bx0) == (slot.h, slot.w), (
                f"band {slot.name}@r{slot.resolution}: global rect "
                f"{(by1 - by0, bx1 - bx0)} != local {(slot.h, slot.w)}"
                " — tile origin not aligned for this level count")
            # The device blockifies on the band-local 64-grid; Tier-2
            # cells live on the *global* 64-grid. They coincide exactly
            # when no global cell boundary cuts the band interior —
            # guaranteed for power-of-two tile grids (origin offsets are
            # multiples of the band size or of 64), asserted here.
            assert (by0 % (1 << CBLK_EXP) == 0
                    or (by0 % (1 << CBLK_EXP)) + slot.h <= (1 << CBLK_EXP)
                    ), "tile origin splits code-blocks vertically"
            assert (bx0 % (1 << CBLK_EXP) == 0
                    or (bx0 % (1 << CBLK_EXP)) + slot.w <= (1 << CBLK_EXP)
                    ), "tile origin splits code-blocks horizontally"
            band = _Band(slot.name, slot.resolution, c, slot.quant,
                         bx0, bx1, by0, by1, None, None, None)
            resolutions[slot.resolution].append(band)
            band_of_slot[(c, si)] = band
        comp_res.append(resolutions)
    return comp_res, band_of_slot


def _block_layers(blk: t1.CodedBlock,
                  assign: rate_mod.LayerAssignment | None) -> dict:
    """LayerAssignment boundaries -> per-layer BlockLayer slices."""
    if not blk.passes:
        return {}
    layers = {}
    prev_p, prev_b = 0, 0
    for layer, (cp, cb) in enumerate(assign.boundaries):
        if cp > prev_p:
            layers[layer] = t2.BlockLayer(cp - prev_p, blk.data[prev_b:cb])
            prev_p, prev_b = cp, cb
    return layers


@dataclass
class _PrecinctRec:
    comp: int
    res: int
    p_idx: int          # raster index within (comp, res)
    ref_y: int          # reference-grid position (progression ordering)
    ref_x: int
    band_precincts: list


def _build_precincts(comp_res: list, origin: tuple, plan: TilePlan,
                     exps: list, assigns_of) -> list:
    """Partition a tile's bands into precincts (anchored at 0 on each
    *global* resolution grid, T.800 B.6) and fill Tier-2 block state."""
    y0, x0 = origin
    tcx1, tcy1 = x0 + plan.tile_w, y0 + plan.tile_h
    levels = plan.levels
    records = []
    for c, resolutions in enumerate(comp_res):
        for r, bands in enumerate(resolutions):
            e = levels - r
            trx0, trx1 = _ceil_div(x0, 1 << e), _ceil_div(tcx1, 1 << e)
            try0, try1 = _ceil_div(y0, 1 << e), _ceil_div(tcy1, 1 << e)
            if trx1 <= trx0 or try1 <= try0:
                continue
            ppx, ppy = exps[r]
            px_lo, px_hi = trx0 >> ppx, ((trx1 - 1) >> ppx) + 1
            py_lo, py_hi = try0 >> ppy, ((try1 - 1) >> ppy) + 1
            shift = 0 if r == 0 else 1
            p_idx = 0
            for py in range(py_lo, py_hi):
                for px in range(px_lo, px_hi):
                    bps = []
                    for band in bands:
                        pbx0 = (px << ppx) >> shift
                        pbx1 = ((px + 1) << ppx) >> shift
                        pby0 = (py << ppy) >> shift
                        pby1 = ((py + 1) << ppy) >> shift
                        cx0, cx1, cy0, cy1 = band.cell_range
                        kx0 = max(cx0, pbx0 >> CBLK_EXP)
                        kx1 = min(cx1, _ceil_div(pbx1, 1 << CBLK_EXP))
                        ky0 = max(cy0, pby0 >> CBLK_EXP)
                        ky1 = min(cy1, _ceil_div(pby1, 1 << CBLK_EXP))
                        nbw, nbh = max(0, kx1 - kx0), max(0, ky1 - ky0)
                        prec = t2.Precinct(nbw, nbh)
                        for i, (cy, cx) in enumerate(
                                (cy, cx) for cy in range(ky0, ky1)
                                for cx in range(kx0, kx1)):
                            blk = band.blocks[(cy, cx)]
                            pb = t2.PrecinctBlock(
                                missing_bitplanes=band.q.n_bitplanes
                                - blk.n_bitplanes)
                            pb.layers = _block_layers(blk, assigns_of(blk))
                            prec.blocks[i] = pb
                        bps.append(prec)
                    ref_y = max(try0, py << ppy) << e
                    ref_x = max(trx0, px << ppx) << e
                    records.append(_PrecinctRec(c, r, p_idx, ref_y, ref_x,
                                                bps))
                    p_idx += 1
    return records


def _packet_sequence(progression: int, records: list, n_res: int,
                     n_comps: int, n_layers: int):
    """Yield (record, layer) in codestream packet order (T.800 B.12).

    Position-based progressions order precincts by their reference-grid
    position; components here always have unit subsampling, so sorting
    by the precinct's (y, x) anchor is exactly the standard's positional
    scan."""
    if progression == cs.PROG_LRCP:
        recs = sorted(records, key=lambda p: (p.res, p.comp, p.p_idx))
        for l in range(n_layers):
            for rec in recs:
                yield rec, l
    elif progression == cs.PROG_RLCP:
        recs = sorted(records, key=lambda p: (p.res, p.comp, p.p_idx))
        for r in range(n_res):
            for l in range(n_layers):
                for rec in recs:
                    if rec.res == r:
                        yield rec, l
    elif progression == cs.PROG_RPCL:
        recs = sorted(records,
                      key=lambda p: (p.res, p.ref_y, p.ref_x, p.comp))
        for rec in recs:
            for l in range(n_layers):
                yield rec, l
    elif progression == cs.PROG_PCRL:
        recs = sorted(records,
                      key=lambda p: (p.ref_y, p.ref_x, p.comp, p.res))
        for rec in recs:
            for l in range(n_layers):
                yield rec, l
    elif progression == cs.PROG_CPRL:
        recs = sorted(records,
                      key=lambda p: (p.comp, p.ref_y, p.ref_x, p.res))
        for rec in recs:
            for l in range(n_layers):
                yield rec, l
    else:
        raise ValueError(f"unknown progression {progression}")


def _tile_parts(params: EncodeParams, tidx: int, records: list,
                n_res: int, n_comps: int) -> list:
    """Encode a tile's packets and split them into tile-parts.

    Returns [(tile_idx, tpsot, tnsot, aux_segments, body)]. With
    ``tparts_r`` and a resolution-major progression this is one
    tile-part per resolution (``ORGtparts=R``), each carrying its own
    PLT when ``gen_plt`` (KakaduConverter.java:40)."""
    split_r = params.tparts_r and params.progression in (cs.PROG_RPCL,
                                                         cs.PROG_RLCP)
    groups: list = []        # [(packets bytes list, lengths list)]
    group_of_res: dict = {}
    sop_counter = 0
    for rec, layer in _packet_sequence(params.progression, records, n_res,
                                       n_comps, params.n_layers):
        pkt = t2.encode_packet(
            rec.band_precincts, layer, params.n_layers,
            sop_index=sop_counter if params.use_sop else None,
            use_eph=params.use_eph)
        sop_counter += 1
        key = rec.res if split_r else 0
        if key not in group_of_res:
            group_of_res[key] = len(groups)
            groups.append(([], []))
        pkts, lens = groups[group_of_res[key]]
        pkts.append(pkt)
        lens.append(len(pkt))

    parts = []
    tnsot = len(groups)
    for tpsot, (pkts, lens) in enumerate(groups):
        aux = [cs.plt(lens, zplt=tpsot)] if params.gen_plt else []
        parts.append((tidx, tpsot, tnsot, aux, b"".join(pkts)))
    return parts


def _band_weight(slot, gains) -> float:
    """PCRD distortion weight: (step x 2-D synthesis L2 norm)²."""
    ll_gain, band_gains = gains
    if slot.name == "LL":
        g = ll_gain
    else:
        lvl = len(band_gains) - slot.resolution + 1
        g = band_gains[lvl - 1][slot.name]
    return (slot.quant.delta * g) ** 2


def _legacy_tier1(groups: dict, plans: dict, img: np.ndarray,
                  params: EncodeParams, used_mct: bool, gains,
                  weight_of_slot: dict, device, tm: dict, mesh=None):
    """Host Tier-1 over raw coefficient planes: each shape group is
    transformed in one batch, its planes come back to the host, and the
    code-blocks are sliced there, clipped to the global cell grid, and
    coded by t1_batch.encode_blocks. Two callers:

    - tile grids whose sub-bands *straddle* global 64-grid cells (a tile
      size divisible by 2^levels but not a multiple of 64, e.g. 96): the
      device front-end cannot blockify these, so the transform runs on
      ``device``. Tile sizes whose global band rects disagree with the
      local Mallat geometry never reach here — encode_array raises for
      those.
    - mesh-sharded encodes (``mesh`` not None): the transform runs
      data-parallel over the mesh (parallel.batch.run_tiles_sharded), or
      row-sharded with DWT halo copies for a single giant tile
      (parallel.sharded_dwt.sharded_transform_tile), on the mesh's own
      devices.

    ``tm`` gains the transform and copy-back seconds ("device") and the
    slicing and coding seconds ("host").

    Returns (tile_records, coded blocks, weights, qcd_values)."""
    from .pipeline import extract_bands, run_tiles

    if mesh is not None:
        from ..parallel.batch import run_tiles_sharded
        from ..parallel.mesh import TILE_AXIS
        from ..parallel.sharded_dwt import (can_row_shard,
                                            sharded_transform_tile)

    def transform(plan: TilePlan, batch: np.ndarray) -> np.ndarray:
        if mesh is None:
            return run_tiles(plan, batch, device=device)
        n_rows = mesh.shape[TILE_AXIS]
        if (batch.shape[0] == 1 and n_rows > 1
                and can_row_shard(plan.tile_h, plan.levels, n_rows)):
            return sharded_transform_tile(plan, batch[0], mesh)[None]
        return run_tiles_sharded(plan, batch, mesh)

    specs: list = []
    dests: list = []
    tile_records = []
    qcd_values = None
    norms = _RCT_NORMS if params.lossless else _ICT_NORMS
    for (th, tw), members in groups.items():
        plan = plans[(th, tw)]
        t0 = time.perf_counter()
        batch = np.stack([img[y0:y0 + th, x0:x0 + tw]
                          for _, y0, x0 in members])
        planes = transform(plan, batch)
        t1_ = time.perf_counter()
        tm["device"] += t1_ - t0
        if qcd_values is None:
            qcd_values = _qcd_values(plan)
        for s in plan.slots:
            weight_of_slot.setdefault((s.resolution, s.name),
                                      _band_weight(s, gains))
        for (tidx, y0, x0), tile_planes in zip(members, planes):
            tcx1, tcy1 = x0 + plan.tile_w, y0 + plan.tile_h
            comp_res = []
            for c in range(plan.n_comps):
                resolutions = []
                for res_bands in extract_bands(tile_planes[c], plan):
                    bands = []
                    for slot, mags, signs, fracs in res_bands:
                        bx0, bx1, by0, by1 = _band_rect(
                            x0, tcx1, y0, tcy1, slot.resolution,
                            slot.name, plan.levels)
                        if (by1 - by0, bx1 - bx0) != (slot.h, slot.w):
                            raise ValueError(
                                "tile origin not aligned for this level "
                                "count")
                        band = _Band(slot.name, slot.resolution, c,
                                     slot.quant, bx0, bx1, by0, by1,
                                     mags, signs, fracs)
                        _collect_blocks(band, specs, dests)
                        bands.append(band)
                    resolutions.append(bands)
                comp_res.append(resolutions)
            tile_records.append((tidx, (y0, x0), plan, comp_res))
        tm["host"] += time.perf_counter() - t1_

    t0 = time.perf_counter()
    coded = t1_batch.encode_blocks(specs)
    blocks = []
    weights = []
    for (band, cy, cx), blk in zip(dests, coded):
        band.blocks[(cy, cx)] = blk
        blocks.append(blk)
        cw = norms[band.comp] ** 2 if used_mct else 1.0
        weights.append(weight_of_slot[(band.res, band.name)] * cw)
    for _, _, _, comp_res in tile_records:
        for resolutions in comp_res:
            for bands in resolutions:
                for band in bands:
                    band.mags = band.signs = band.fracs = None
    tm["host"] += time.perf_counter() - t0
    return tile_records, blocks, weights, qcd_values


@dataclass
class _Chunk:
    """Up to CHUNK_TILES same-shape tiles plus the host-side metadata
    joining the device's canonical block order to Tier-2's cells."""
    plan: TilePlan
    members: list            # [(tidx, y0, x0)]
    dests: list              # [(band, cy, cx)] in frontend block order
    hs: np.ndarray
    ws: np.ndarray
    bandnames: list
    wts: np.ndarray          # PCRD distortion weight per block
    ns: np.ndarray           # true samples per block
    pending: object = None   # frontend.PendingFrontend while queued
    fres: object = None      # frontend.FrontendResult once resolved


def _build_chunks(groups: dict, plans: dict, used_mct: bool, gains,
                  weight_of_slot: dict, norms) -> tuple:
    """Split shape groups into chunks (order is deterministic: group
    dict order, then member order). Returns (chunks, tile_records,
    qcd_values)."""
    tile_records: list = []
    chunks: list = []
    qcd_values = None
    for (th, tw), members in groups.items():
        plan = plans[(th, tw)]
        if qcd_values is None:
            qcd_values = _qcd_values(plan)
        for s in plan.slots:
            weight_of_slot.setdefault((s.resolution, s.name),
                                      _band_weight(s, gains))
        layout = frontend.layout_for(plan)
        for i in range(0, len(members), CHUNK_TILES):
            part = members[i:i + CHUNK_TILES]
            dests, hs, ws, bandnames, wts, ns = [], [], [], [], [], []
            for (tidx, y0, x0) in part:
                comp_res, band_of_slot = _tile_bands(plan, (y0, x0))
                tile_records.append((tidx, (y0, x0), plan, comp_res))
                for m in layout.metas:
                    band = band_of_slot[(m.comp, m.slot_i)]
                    cx0, _, cy0, _ = band.cell_range
                    dests.append((band, cy0 + m.iy, cx0 + m.ix))
                    hs.append(m.h)
                    ws.append(m.w)
                    bandnames.append(band.name)
                    cw = norms[m.comp] ** 2 if used_mct else 1.0
                    wts.append(weight_of_slot[(band.res, band.name)] * cw)
                    ns.append(m.h * m.w)
            chunks.append(_Chunk(plan, part, dests,
                                 np.asarray(hs, np.int32),
                                 np.asarray(ws, np.int32), bandnames,
                                 np.asarray(wts), np.asarray(ns)))
    return chunks, tile_records, qcd_values


def encode_array(img: np.ndarray, bitdepth: int = 8,
                 params: EncodeParams | None = None, mesh=None,
                 device="cuda", stats: dict | None = None) -> bytes:
    """Encode a (H, W) or (H, W, 3) array into a raw JPEG 2000 codestream.

    The transform and the device side of Tier-1 run on ``device``
    ("cuda" unless the caller asks for "cpu", where every kernel runs its
    plain PyTorch version). ``stats``: optional dict that receives the
    encode's Tier-1 volume — code-blocks and MQ bytes of the final pass
    set, and the coded symbols where the Tier-1 counts them (the host
    block coder does not: ``"symbols"`` is then absent).
    ``mesh``: optional DeviceMesh (parallel.mesh.make_mesh) of
    ``device``'s type. When given, the sample transform runs on the
    mesh's devices — data-parallel over tile batches, or row-sharded
    with DWT halo copies for a single giant tile — and Tier-1 runs on
    host planes (the same bytes as the single-device encode).
    """
    params = params or EncodeParams()
    if mesh is not None and mesh.device_type != torch.device(device).type:
        raise ValueError(
            f"a mesh of {mesh.device_type} devices asked of an encode on "
            f"{device}: build the mesh on {torch.device(device).type} "
            "devices")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"encode on {device} asked for, but CUDA is unavailable: this "
            "torch build or machine has no usable CUDA device (pass "
            "device=\"cpu\" to encode on the host)")
    mode = _tier1_mode(params, device)
    h, w = img.shape[:2]
    n_comps = 1 if img.ndim == 2 else img.shape[2]
    if n_comps not in (1, 3):
        raise ValueError(f"components must be 1 or 3, got {n_comps}")
    tile = params.tile_size or max(h, w)
    levels = params.levels

    if img.ndim == 2:
        img = img[..., None]
    if n_comps != 3:
        used_mct = False
    elif params.mct == "on":
        used_mct = True
    elif params.mct == "off":
        used_mct = False
    else:
        used_mct = _mct_helps(img, params.lossless,
                              None if params.lossless else params.rate,
                              params.base_delta)

    # Group tiles by shape: interior tiles batch together; ragged
    # right/bottom tiles form up to three more groups.
    n_tiles_x = _ceil_div(w, tile)
    n_tiles_y = _ceil_div(h, tile)
    groups: dict = {}
    for ty in range(n_tiles_y):
        for tx in range(n_tiles_x):
            y0, x0 = ty * tile, tx * tile
            th, tw = min(tile, h - y0), min(tile, w - x0)
            groups.setdefault((th, tw), []).append(
                (ty * n_tiles_x + tx, y0, x0))

    gains = synthesis_gains(levels, params.lossless)
    weight_of_slot: dict = {}
    target = None
    if params.rate is not None and not params.lossless:
        target = params.rate * w * h / 8.0
    norms = _RCT_NORMS if params.lossless else _ICT_NORMS
    plans = {shape: make_plan(shape[0], shape[1], n_comps, levels,
                              params.lossless, bitdepth, params.base_delta,
                              use_mct=used_mct) for shape in groups}

    states = {_grid_aligned(plans[shape], (y0, x0))
              for shape, members in groups.items()
              for _, y0, x0 in members}
    if "mismatch" in states:
        raise NotImplementedError(
            f"tile size {tile} with {levels} decomposition levels: the "
            "global band rectangle of a tile disagrees with its local "
            "Mallat geometry, so it cannot be coded. Use a tile size "
            f"divisible by 2^levels ({1 << levels}), or fewer levels.")
    tm = {"device": 0.0, "host": 0.0, "cxd": 0.0, "mq": 0.0,
          "mq_dev": 0.0}
    t_wall0 = time.perf_counter()
    svc = current_services()
    if mesh is not None or "straddle" in states:
        # Host-side block slicing, whatever Tier-1 the params asked for:
        # sharded transforms (mesh) or grids whose sub-bands straddle
        # the global 64-grid cells.
        if svc is not None and svc.check is not None:
            svc.check()
        tile_records, all_coded, block_weights, qcd_values = \
            _legacy_tier1(groups, plans, img, params, used_mct, gains,
                          weight_of_slot, device, tm, mesh=mesh)
        if _metrics_sink is not None:
            _record_encode("legacy", tm, time.perf_counter() - t_wall0,
                           h * w, 0, 0)
        if stats is not None:
            stats["blocks"] = len(all_coded)
            stats["bytes"] = sum(len(b.data) for b in all_coded)
        assign_index = {id(b): i for i, b in enumerate(all_coded)}
        with obs.span("encode.tier2"):
            return _finish(img, params, tile_records, all_coded,
                           block_weights, assign_index, qcd_values,
                           used_mct, bitdepth, n_comps, levels, tile,
                           target)

    chunks, tile_records, qcd_values = _build_chunks(
        groups, plans, used_mct, gains, weight_of_slot, norms)
    frac_bits = 0 if params.lossless else FRAC_BITS
    floor_lam = [0.0]
    # A shared scheduler pool may run two of this encode's host Tier-1
    # jobs at once: serialize the timing accumulator so segments stay
    # exact.
    tm_lock = threading.Lock()
    # Symbols and MQ bytes over every Tier-1 attempt (the host block
    # coder counts no symbols).
    coded = [0, 0]

    def _tm_add(key: str, dt: float) -> None:
        with tm_lock:
            tm[key] += dt

    def dispatch(chunk: _Chunk) -> None:
        if svc is not None and svc.check is not None:
            svc.check()
        t0 = time.perf_counter()
        with obs.span("encode.dispatch", tiles=len(chunk.members)):
            batch = np.stack([img[y0:y0 + chunk.plan.tile_h,
                                  x0:x0 + chunk.plan.tile_w]
                              for _, y0, x0 in chunk.members])
            if svc is not None and svc.dispatch is not None:
                chunk.pending = svc.dispatch(chunk.plan, batch, mode=mode)
            else:
                chunk.pending = frontend.dispatch_frontend(
                    chunk.plan, batch, mode=mode, device=device)
        _tm_add("device", time.perf_counter() - t0)

    def resolve(chunk: _Chunk) -> None:
        t0 = time.perf_counter()
        with obs.span("encode.resolve_stats"):
            chunk.fres = chunk.pending.resolve_stats()
        chunk.pending = None
        _tm_add("device", time.perf_counter() - t0)

    def host_replay(chunk: _Chunk, streams) -> cxd_mod.MqDeviceResult:
        """The split's host half: MQ replay of the device's symbols."""
        t0 = time.perf_counter()
        with obs.span("encode.mq_replay", blocks=len(chunk.dests)):
            blocks = t1_batch.encode_cxd(streams)
            if not params.lossless:
                _correct_distortions(blocks, chunk.fres)
        dt = time.perf_counter() - t0
        _tm_add("host", dt)
        _tm_add("mq", dt)
        return cxd_mod.MqDeviceResult(blocks, streams.total_syms,
                                      sum(len(b.data) for b in blocks),
                                      0.0, 0.0, dt)

    def host_code(chunk: _Chunk, floors: np.ndarray, payload: np.ndarray,
                  offsets: np.ndarray) -> cxd_mod.MqDeviceResult:
        """The host Tier-1 over one chunk's packed payload: context
        modeling and MQ coding in C++ on the host's cores."""
        t0 = time.perf_counter()
        with obs.span("encode.host_t1", blocks=len(chunk.dests)):
            blocks = t1_batch.encode_packed(payload, offsets,
                                            chunk.fres.nbps, floors,
                                            chunk.hs, chunk.ws,
                                            chunk.bandnames)
            if not params.lossless:
                _correct_distortions(blocks, chunk.fres)
        dt = time.perf_counter() - t0
        _tm_add("host", dt)
        return cxd_mod.MqDeviceResult(blocks, None,
                                      sum(len(b.data) for b in blocks),
                                      0.0, 0.0, dt)

    def tier1(pool, chunk: _Chunk, floors: np.ndarray, release: bool,
              futs: list) -> None:
        """Queue one chunk's Tier-1 result onto ``futs``. The fused path
        finishes here; the split's host replay and the host Tier-1 run
        on the host pool while the caller goes on to the next chunk's
        device work."""
        args = (chunk.fres.nbps, floors, chunk.bandnames, chunk.hs,
                chunk.ws, frac_bits)
        if mode == "mq":
            def t1_stage(blocks_dev):
                return cxd_mod.run_device_mq(blocks_dev, *args)

            with obs.span("encode.t1_device", blocks=len(chunk.dests)):
                if svc is not None and svc.t1_launch is not None:
                    # Pipeline-stage mapping: the scheduler stages the
                    # fused kernel onto its Tier-1 device subset; the
                    # span covers staging wait and execution.
                    res = svc.t1_launch(t1_stage, chunk.fres.blocks)
                else:
                    res = t1_stage(chunk.fres.blocks)
            _tm_add("device", res.cxd_s + res.mq_s)
            _tm_add("cxd", res.cxd_s)
            _tm_add("mq_dev", res.mq_s)
            with tm_lock:
                coded[0] += res.total_syms
                coded[1] += res.total_bytes
            th0 = time.perf_counter()
            if not params.lossless:
                _correct_distortions(res.blocks, chunk.fres)
            # The whole host share: assembly + distortion correction.
            _tm_add("host", res.host_s + time.perf_counter() - th0)
            fut: Future = Future()
            fut.set_result(res)
        else:
            if mode == "cxd":
                with obs.span("encode.cxd_device",
                              blocks=len(chunk.dests)):
                    streams = cxd_mod.run_cxd(chunk.fres.blocks, *args)
                _tm_add("device", streams.device_s)
                _tm_add("cxd", streams.device_s)
                with tm_lock:
                    coded[0] += streams.total_syms
                job = (host_replay, chunk, streams)
            else:
                t0 = time.perf_counter()
                src, offsets = frontend.payload_plan(
                    chunk.fres.nbps, floors, chunk.fres.layout.P)
                payload = frontend.fetch_payload(chunk.fres, src)
                _tm_add("device", time.perf_counter() - t0)
                job = (host_code, chunk, floors, payload, offsets)
            # Back-pressure: at most HOST_QUEUE_DEPTH unfinished host
            # jobs, so the fetched payloads stay bounded.
            live = [f for f in futs if not f.done()]
            if len(live) > HOST_QUEUE_DEPTH:
                live[0].result()
            # obs.bind: pool threads do not inherit the trace context.
            fut = pool.submit(obs.bind(job[0]), *job[1:])
        if release:
            # Free the device staging buffer (a merged launch's rows are
            # shared: they go when the last window lets go of them).
            chunk.fres.blocks = chunk.fres.rows = None
        futs.append(fut)

    def chunk_floors(margin: float) -> list:
        # Plane capacity could in principle differ between shape
        # groups; pad the per-plane stats to the widest.
        pmax = max(c.fres.layout.P for c in chunks)

        def padp(a):
            return np.pad(a, ((0, 0), (0, pmax - a.shape[1])))

        nbps = np.concatenate([c.fres.nbps for c in chunks])
        newsig = np.concatenate([padp(c.fres.newsig) for c in chunks])
        sigd = np.concatenate([padp(c.fres.sigd) for c in chunks])
        refd = np.concatenate([padp(c.fres.refd) for c in chunks])
        wts = np.concatenate([c.wts for c in chunks])
        ns = np.concatenate([c.ns for c in chunks])
        floors, floor_lam[0] = rate_mod.estimate_floors(
            nbps, newsig, sigd, refd, wts, ns, target, margin)
        out, ofs = [], 0
        for c in chunks:
            out.append(floors[ofs:ofs + c.fres.n_blocks])
            ofs += c.fres.n_blocks
        return out

    # The host Tier-1 (the split's replay, the packed payload's coding)
    # runs on the scheduler's shared pool when one is installed (never
    # shut down here), else on one private worker beside the main thread
    # (ctypes releases the interpreter lock for the native coder).
    # Results are collected in submission order either way, so the
    # output is the same as a serial run's.
    if svc is not None and svc.pool is not None:
        pool_cm = contextlib.nullcontext(svc.pool)
    else:
        pool_cm = ThreadPoolExecutor(max_workers=1)
    with pool_cm as pool:
        futs: list = []
        if target is None:
            # Streaming: floors are all zero, so each chunk flows
            # dispatch -> resolve -> Tier-1 on its own, with at most
            # OVERLAP_DEPTH chunks queued ahead of the one being coded.
            staged: deque = deque()
            for chunk in chunks + [None] * OVERLAP_DEPTH:
                if chunk is not None:
                    dispatch(chunk)
                    staged.append(chunk)
                if staged and (chunk is None
                               or len(staged) >= OVERLAP_DEPTH):
                    c = staged.popleft()
                    resolve(c)
                    tier1(pool, c, np.zeros(c.fres.n_blocks, np.int32),
                          True, futs)
            results = [f.result() for f in futs]
        else:
            # Rate-targeted: floors need global stats, so every chunk's
            # front-end runs first (blocks stay on the device — a later
            # margin attempt re-codes deeper planes), then Tier-1 per
            # chunk.
            for chunk in chunks:
                dispatch(chunk)
            for chunk in chunks:
                resolve(chunk)
            margin = 3.0
            for attempt in range(3):
                if attempt and _metrics_sink is not None:
                    _metrics_sink.count("encode.floor_reruns")
                floors_by_chunk = chunk_floors(margin)
                futs = []
                for chunk, floors in zip(chunks, floors_by_chunk):
                    tier1(pool, chunk, floors, False, futs)
                results = [f.result() for f in futs]
                avail = sum(len(b.data) for res in results
                            for b in res.blocks)
                if avail >= 1.05 * target:
                    if attempt == 2 or avail >= 2.0 * target:
                        # Out of retries, or supply is so abundant that
                        # PCRD's cut sits far above the floor tail.
                        break
                    # Supply is snug: compare the realized PCRD cut
                    # slope against the floor threshold.
                    flat = [b for res in results for b in res.blocks]
                    wts_all = np.concatenate([c.wts for c in chunks])
                    realized = rate_mod.cut_slope(flat, wts_all,
                                                  target * 0.96)
                    if realized >= floor_lam[0] / 4.0:
                        break
                    if _metrics_sink is not None:
                        _metrics_sink.count("encode.floor_slope_retries")
                # Estimator undershoot: lower the floors and redo — PCRD
                # needs enough passes to spend the budget.
                margin *= 4.0

    if _metrics_sink is not None:
        _record_encode(mode, tm, time.perf_counter() - t_wall0, h * w,
                       *coded)

    all_coded: list = []
    block_weights: list = []
    assign_index: dict = {}     # id(CodedBlock) -> index
    with obs.span("encode.reassemble", chunks=len(chunks)):
        for chunk, res in zip(chunks, results):
            for (band, cy, cx), blk, bw in zip(chunk.dests, res.blocks,
                                               chunk.wts):
                if blk.n_bitplanes > band.q.n_bitplanes:
                    raise ValueError(
                        f"block bitplanes {blk.n_bitplanes} exceed Mb "
                        f"{band.q.n_bitplanes} in {band.name}")
                band.blocks[(cy, cx)] = blk
                assign_index[id(blk)] = len(all_coded)
                all_coded.append(blk)
                block_weights.append(bw)
            chunk.fres = None     # release stats + any remaining blocks
    if stats is not None:
        stats["blocks"] = len(all_coded)
        if mode != "rows":
            stats["symbols"] = sum(res.total_syms for res in results)
        stats["bytes"] = sum(res.total_bytes for res in results)
    with obs.span("encode.tier2"):
        return _finish(img, params, tile_records, all_coded,
                       block_weights, assign_index, qcd_values, used_mct,
                       bitdepth, n_comps, levels, tile, target)


def _record_encode(mode: str, tm: dict, wall_s: float, pixels: int,
                   n_syms: int, n_mq_bytes: int) -> None:
    """One encode's segments on the metrics sink, under the JAX
    package's stage and counter names. ``mode`` is the front-end mode,
    or "legacy" for the host-sliced straddling grids; the host Tier-1
    modes ("rows", "legacy") record only the device and host segments,
    as the JAX package's host path does."""
    sink = _metrics_sink
    sink.record("encode.device_dispatch", tm["device"], pixels=pixels)
    sink.record("encode.host_code", tm["host"], pixels=pixels)
    if mode == "mq":
        # The fused Tier-1's segments: the launches, the byte-segment
        # fetch (items=bytes) and their sum (items=symbols).
        sink.record("encode.cxd_device", tm["cxd"], pixels=pixels)
        sink.record("encode.mq_device", tm["mq_dev"], pixels=pixels,
                    items=n_mq_bytes)
        sink.record("encode.t1_device_total", tm["cxd"] + tm["mq_dev"],
                    pixels=pixels, items=n_syms)
        sink.count("encode.mq_device_bytes", n_mq_bytes)
        sink.count("encode.cxd_symbols", n_syms)
    elif mode == "cxd":
        # The split's host MQ replay, with its symbol throughput.
        sink.record("encode.cxd_device", tm["cxd"], pixels=pixels)
        sink.record("encode.mq_replay", tm["mq"], pixels=pixels,
                    items=n_syms)
        sink.count("encode.cxd_symbols", n_syms)
    sink.record_overlap("encode", tm["device"], tm["host"], wall_s,
                        pixels=pixels)


def _finish(img: np.ndarray, params: EncodeParams, tile_records: list,
            all_blocks: list, block_weights: list, assign_index: dict,
            qcd_values: list, used_mct: bool, bitdepth: int, n_comps: int,
            levels: int, tile: int, target: float | None) -> bytes:
    """PCRD layer allocation + Tier-2 + codestream assembly, iterated a
    few times so the assembled file size (headers included) lands on the
    byte target."""
    h, w = img.shape[:2]
    exps = _precinct_exps(params, levels)
    segs = [
        cs.siz(w, h, n_comps, bitdepth, tile, tile),
        cs.cod(params.progression, params.n_layers,
               use_mct=used_mct, levels=levels,
               cblk_w_exp=CBLK_EXP, cblk_h_exp=CBLK_EXP,
               reversible=params.lossless,
               precinct_exps=exps if params.precincts else None,
               use_sop=params.use_sop, use_eph=params.use_eph),
        cs.qcd(0 if params.lossless else 2, GUARD_BITS, qcd_values),
    ]
    if params.comment:
        segs.append(cs.com(params.comment))

    def build(budget: float | None) -> bytes:
        assigns = rate_mod.allocate(all_blocks, block_weights,
                                    params.n_layers, budget)

        def assigns_of(blk):
            return assigns[assign_index[id(blk)]]

        parts = []
        for tidx, origin, plan, comp_res in sorted(tile_records,
                                                   key=lambda t: t[0]):
            records = _build_precincts(comp_res, origin, plan, exps,
                                       assigns_of)
            parts.extend(_tile_parts(params, tidx, records, levels + 1,
                                     n_comps))
        return cs.assemble_parts(segs, parts)

    if target is None:
        return build(None)

    # Budget the block bytes, then correct for actual header overhead.
    budget = max(1024.0, target * 0.96)
    out = build(budget)
    for _ in range(3):
        err = len(out) - target
        if abs(err) <= 0.02 * target:
            break
        budget = max(1024.0, budget - err)
        # Each extra Tier-2 rebuild multiplies worst-case encode cost;
        # count them so adversarial-content blowups are observable.
        if _metrics_sink is not None:
            _metrics_sink.count("encode.t2_rebuilds")
        out = build(budget)
    return out


def _correct_distortions(blocks: list, fres) -> None:
    """Rescale Tier-1's per-pass distortions to the front-end's exact
    per-plane sums.

    Tier-1 sees integer indices only (and, under a bit-plane floor, no
    low integer bits), so its midpoint distortions are biased; the
    front-end computed the exact per-plane significance/refinement
    distortion totals from the full fixed-point coefficients
    (frontend._frontend_body). Pass-level granularity is recovered by
    scaling each pass in plane p by the exact/estimated plane-total
    ratio for its kind (sig = SPP+CP, ref = MRP)."""
    P = fres.layout.P
    for bi, blk in enumerate(blocks):
        if not blk.passes:
            continue
        est_sig = [0.0] * P
        est_ref = [0.0] * P
        for info in blk.passes:
            if info.pass_type == 1:
                est_ref[info.bitplane] += info.dist_reduction
            else:
                est_sig[info.bitplane] += info.dist_reduction
        for info in blk.passes:
            p = info.bitplane
            est = est_ref[p] if info.pass_type == 1 else est_sig[p]
            exact = (fres.refd[bi, p] if info.pass_type == 1
                     else fres.sigd[bi, p])
            if est > 0.0 and exact >= 0.0:
                info.dist_reduction *= exact / est


def _qcd_values(plan: TilePlan) -> list:
    vals = []
    for slot in plan.slots:
        if plan.lossless:
            vals.append(slot.quant.exponent)
        else:
            vals.append((slot.quant.exponent, slot.quant.mantissa))
    return vals


def _tier1_mode(params: EncodeParams, device) -> str:
    """The front-end mode that places this encode's Tier-1: "mq" (the
    fused fused_t1 kernel), "cxd" (the cxd_scan split with the host MQ
    replay) or "rows" (the host block coder over planes packed on the
    device).

    An explicit ``device_mq`` wins: True is "mq" on any device. With
    ``device_mq=None`` the fused Tier-1 runs on a CUDA device only —
    the card is this port's accelerator, so this is the JAX package's
    "device MQ on a TPU" default (bucketeer_tpu.codec.encoder
    ``_device_mq``). Off the card, as the JAX package off a TPU, the
    plain versions of the scans would emulate the device, so the encode
    takes the split when ``device_cxd`` is set and the host Tier-1
    otherwise. Nothing here reads the environment.
    """
    use_mq = params.device_mq
    if use_mq is None:
        use_mq = torch.device(device).type == "cuda"
    if use_mq:
        return "mq"
    return "cxd" if params.device_cxd else "rows"


def encode_jp2(img: np.ndarray, bitdepth: int = 8,
               params: EncodeParams | None = None, jpx: bool = False,
               mesh=None, device="cuda", stats: dict | None = None) -> bytes:
    """Encode to a boxed .jp2 / .jpx file image (see encode_array)."""
    code = encode_array(img, bitdepth, params, mesh=mesh, device=device,
                        stats=stats)
    h, w = img.shape[:2]
    n_comps = 1 if img.ndim == 2 else img.shape[2]
    return jp2box.wrap(code, w, h, n_comps, bitdepth, jpx=jpx)
