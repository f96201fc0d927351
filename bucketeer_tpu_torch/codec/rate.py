"""PCRD-opt rate control: rate-distortion-optimal truncation of Tier-1
pass streams into quality layers (T.800 Annex J.10 / EBCOT's
post-compression rate-distortion optimization).

The reference delegates this to Kakadu's ``-rate 3`` / ``Clayers=6``
options (reference: converters/KakaduConverter.java:38-43); here it is
explicit: every code-block's feasible truncation points (pass ends) are
reduced to their convex hull in (bytes, weighted-distortion) space, hull
segments are merged globally by R-D slope, and layer boundaries are byte
budgets on that global slope-ordered walk — so layer L is exactly "the
best bytes to spend first", which is what makes the 6-layer progressive
stream meaningful.

Distortion weighting: Tier-1 reports per-pass distortion reduction in
quantizer-index units²; multiplying by (delta_b * g_b)² — quantizer step
times the 2-D L2 synthesis norm of the subband — converts to image-domain
MSE so slopes are comparable across subbands and resolutions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Per-plane pass-size model used to pick bit-plane floors *before*
# Tier-1 runs (estimate_floors): estimated coded bits for one plane of
# one block ≈ A_INSIG per still-insignificant sample scanned (ZC
# decisions, mostly run-length-collapsed zeros) + A_SIG per newly
# significant sample (the 1-decision plus sign) + A_REF per refinement
# decision. Calibrated by least squares against actual per-plane MQ pass
# lengths on photographic content (median est/actual 0.95, p5 0.78,
# p95 2.0; guardrail:
# tests/test_codec_roundtrip.py::test_floor_estimator_conservative).
# These only gate what ships to the host — PCRD uses
# real measured lengths — so accuracy affects transfer size, not
# correctness; the safety margin covers the residual error.
A_INSIG = 0.18
A_SIG = 2.8
A_REF = 0.95


# A block whose top plane's amortized slope clears the estimator's cut
# threshold divided by this factor is never fully zeroed: it keeps at
# least its MSB plane. Dropping such a block outright risked visible
# quality loss the aggregate byte check could not see (ADVICE r5 #4);
# one top plane of insurance costs ~a few bytes per block.
LIVE_BLOCK_SLACK = 16.0


def estimate_floors(nbps: np.ndarray, newsig: np.ndarray,
                    sigd: np.ndarray, refd: np.ndarray,
                    weights: np.ndarray, n_samples: np.ndarray,
                    target_bytes: float, margin: float = 3.0):
    """Choose a per-block lowest bit-plane to code, from device front-end
    statistics (codec/frontend.py), so Tier-1 skips work (and the device
    skips transfer) that PCRD-opt would discard anyway.

    nbps (N,), newsig/sigd/refd (N, P), weights (N,) PCRD distortion
    weights, n_samples (N,) true samples per block. Picks the largest
    slope threshold whose contiguous-from-MSB plane selection costs
    ~margin x target_bytes by the pass-size model above, then grants one
    extra plane of safety. Returns (floors (N,), cut_slope): a floor ==
    nbp marks a block that ships nothing — but a live block whose top
    plane clears the threshold / LIVE_BLOCK_SLACK always keeps its MSB
    plane. ``cut_slope`` is the slope threshold actually applied; the
    encoder compares it to PCRD's realized cut to detect floors that
    clipped passes the allocator wanted (and then retries with a bigger
    margin).
    """
    n, P = newsig.shape
    planes = np.arange(P)
    valid = planes[None, :] < nbps[:, None]
    # Samples already significant when plane p is coded = those whose
    # MSB sits in a higher plane.
    cum = np.cumsum(newsig[:, ::-1], axis=1)[:, ::-1]
    sig_before = cum - newsig
    insig = np.maximum(0, n_samples[:, None] - sig_before)
    est_bits = A_INSIG * insig + A_SIG * newsig + A_REF * sig_before
    est_bytes = np.where(valid, np.maximum(est_bits / 8.0, 1.0), 0.0)
    dist = np.where(valid, np.maximum((sigd + refd), 0.0)
                    * weights[:, None], 0.0)
    # Contiguity from the MSB with amortization: a plane's worth is the
    # *average* slope of everything from the MSB down to it (a dud plane
    # must not orphan a valuable one below it — the PCRD hull amortizes
    # such passes the same way). Running-min keeps the include set
    # contiguous when the average wobbles.
    cum_d = np.cumsum(dist[:, ::-1], axis=1)
    cum_b = np.cumsum(est_bytes[:, ::-1], axis=1)
    avg = (cum_d / np.maximum(cum_b, 1e-9))[:, ::-1]
    slope_mono = np.where(valid, avg, np.inf)[:, ::-1]
    slope_mono = np.minimum.accumulate(slope_mono, axis=1)[:, ::-1]
    slope_mono = np.where(valid, slope_mono, 0.0)
    cum_b = cum_b[:, ::-1]      # cum_b[b, p] = est bytes for planes >= p

    budget = margin * target_bytes
    pos = slope_mono[valid & (slope_mono > 0)]
    if pos.size == 0:
        return nbps.copy(), 0.0

    def cost_at(lam: float) -> float:
        inc = valid & (slope_mono >= lam)
        any_inc = inc.any(axis=1)
        lowest = np.argmax(inc, axis=1)
        return float(cum_b[np.nonzero(any_inc)[0], lowest[any_inc]].sum())

    lo, hi = float(pos.min()) * 0.5, float(pos.max()) * 2.0
    for _ in range(40):
        lam = (lo * hi) ** 0.5
        if cost_at(lam) > budget:
            lo = lam
        else:
            hi = lam
    included = valid & (slope_mono >= hi)
    any_inc = included.any(axis=1)
    # One extra plane of safety below the estimated cut for live blocks;
    # blocks with nothing over the threshold ship nothing — unless their
    # top plane clears the loose threshold, in which case they keep the
    # MSB plane (never fully zero a plausibly-live block, ADVICE r5 #4).
    lowest = np.argmax(included, axis=1)
    live = nbps > 0
    top_slope = np.where(
        live, slope_mono[np.arange(n), np.maximum(nbps - 1, 0)], 0.0)
    keep_top = (~any_inc) & live & (top_slope >= hi / LIVE_BLOCK_SLACK)
    floors = np.where(any_inc, np.maximum(0, lowest - 1), nbps)
    floors = np.where(keep_top, nbps - 1, floors)
    return np.minimum(floors, nbps).astype(np.int32), float(hi)


def truncation_lengths(byte_snaps, data_len):
    """Feasible truncation points from device-emitted per-pass byte
    counts (codec/cxd.py device-MQ mode): the MQ coder's conservative
    rule — bytes emitted at the pass boundary plus 4 bytes of
    decodable-prefix slack (``MQEncoder.truncation_length``) — capped
    at the flushed stream length, exactly as the host replay caps its
    recorded lengths. PCRD's hulls (:func:`allocate`) and the realized
    cut (:func:`cut_slope`) consume these; byte parity with the
    host-MQ path requires this mapping bit for bit."""
    return np.minimum(np.asarray(byte_snaps, dtype=np.int64) + 4,
                      int(data_len))


def cut_slope(blocks: list, weights: list,
              target_bytes: float | None) -> float:
    """Approximate realized PCRD cut: the marginal R-D slope at the
    byte budget, from raw per-pass slopes (no hull amortization — one
    cheap numpy pass instead of rebuilding every block hull the
    allocator will build again anyway). The encoder compares this
    against estimate_floors' threshold with 4x slack — a realized cut
    far below the floor threshold means the floors clipped passes PCRD
    wanted, so the floor pass must be redone with a bigger margin."""
    if target_bytes is None:
        return 0.0
    slopes, lens = [], []
    for blk, w in zip(blocks, weights):
        prev = 0
        for p in blk.passes:
            dl = p.cum_length - prev
            prev = p.cum_length
            if dl > 0 and p.dist_reduction > 0:
                slopes.append(p.dist_reduction * w / dl)
                lens.append(dl)
    if not slopes:
        return 0.0
    s = np.asarray(slopes)
    order = np.argsort(-s)
    cum = np.cumsum(np.asarray(lens, dtype=np.float64)[order])
    k = int(np.searchsorted(cum, target_bytes))
    if k >= len(s):
        return 0.0      # everything fit: the cut never bound
    return float(s[order[k]])


@dataclass
class LayerAssignment:
    """Per-block result: for each layer, the cumulative (n_passes, bytes)
    boundary after that layer's contribution. Layers with no new passes
    for this block simply repeat the previous boundary."""
    boundaries: list        # [(cum_passes, cum_bytes)] per layer


def _hull(block, weight: float):
    """Lower-rate/upper-distortion convex hull of a block's truncation
    points. Returns [(pass_idx, cum_len, cum_dist)] with strictly
    decreasing slopes between consecutive points (origin excluded)."""
    pts = [(-1, 0, 0.0)]
    cum = 0.0
    for i, p in enumerate(block.passes):
        cum += p.dist_reduction * weight
        pts.append((i, p.cum_length, cum))

    hull = [pts[0]]
    for pt in pts[1:]:
        if pt[1] <= hull[-1][1]:
            # No extra bytes: keep whichever has more distortion benefit
            # (later pass index wins ties so npasses stays consistent).
            if pt[2] >= hull[-1][2] and len(hull) > 1:
                hull[-1] = pt
            continue
        while len(hull) >= 2:
            x0, y0 = hull[-2][1], hull[-2][2]
            x1, y1 = hull[-1][1], hull[-1][2]
            # Slope to candidate from hull[-2] >= slope of last segment
            # means hull[-1] is not on the upper hull.
            if (pt[2] - y0) * (x1 - x0) >= (y1 - y0) * (pt[1] - x0):
                hull.pop()
            else:
                break
        # Only keep points that improve distortion.
        if pt[2] > hull[-1][2]:
            hull.append(pt)
    return hull


def layer_budgets(target_bytes: float | None, total_bytes: int,
                  n_layers: int) -> list:
    """Cumulative byte budgets per layer: logarithmically spaced halvings
    ending at the target (Kakadu's default layer spacing for
    ``Clayers=N -rate R``). With no target (lossless ``-rate -``), the
    spacing is applied to the actual coded size and the last layer is
    unbounded so every pass ships."""
    final = float(target_bytes) if target_bytes is not None else float(
        total_bytes)
    budgets = [final / (2 ** (n_layers - 1 - i)) for i in range(n_layers)]
    if target_bytes is None:
        budgets[-1] = float("inf")
    return budgets


def allocate(blocks: list, weights: list, n_layers: int,
             target_bytes: float | None) -> list[LayerAssignment]:
    """Assign coding passes to quality layers.

    blocks: list of t1.CodedBlock; weights: per-block distortion weight
    (delta_b * g_b)²; target_bytes: budget for the sum of block bytes
    (codestream headers are the caller's problem), or None = include
    everything (lossless).

    Returns one LayerAssignment per block.
    """
    segments = []   # (slope, block_idx, seg_order, d_len, pass_idx, cum_len)
    for bi, (blk, w) in enumerate(zip(blocks, weights)):
        hull = _hull(blk, w)
        for si in range(1, len(hull)):
            p0, l0, d0 = hull[si - 1]
            p1, l1, d1 = hull[si]
            slope = (d1 - d0) / (l1 - l0)
            segments.append((slope, bi, si, l1 - l0, p1, l1))
    # Global R-D order: steepest slope first; per-block segment order is
    # preserved because hull slopes strictly decrease within a block.
    segments.sort(key=lambda s: (-s[0], s[1], s[2]))

    total = sum(s[3] for s in segments)
    budgets = layer_budgets(target_bytes, total, n_layers)

    state = [(0, 0)] * len(blocks)     # running (cum_passes, cum_bytes)
    assigns = [LayerAssignment([]) for _ in blocks]
    cum = 0
    seg_i = 0
    for layer in range(n_layers):
        budget = budgets[layer]
        while seg_i < len(segments):
            slope, bi, _, d_len, pass_idx, cum_len = segments[seg_i]
            if cum + d_len > budget:
                break
            cum += d_len
            state[bi] = (pass_idx + 1, cum_len)
            seg_i += 1
        for bi in range(len(blocks)):
            assigns[bi].boundaries.append(state[bi])
    if target_bytes is None:
        # No byte budget (lossless `-rate -`): the hull only ordered the
        # *early* layers; the final layer must carry every coding pass,
        # hull point or not, or reconstruction is no longer exact.
        for bi, (blk, _) in enumerate(zip(blocks, weights)):
            if blk.passes:
                assigns[bi].boundaries[-1] = (len(blk.passes),
                                              len(blk.data))
    return assigns
