"""The fused Tier-1's result as columns (codec/cxd.py ``T1Columns``)
against the objects its plain version builds (``assemble_mq_blocks``):
the columns, the encoder's columnar distortion correction and cut slope,
whole encodes, and the tensor codec that materialises the columns, on
the CPU. The parent's path is :func:`_objects_run_device_mq`: the same
launches and fetch, assembled into ``t1.CodedBlock``s, which the encoder
corrects, cuts and flattens as it does the host coders' blocks."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from bucketeer_tpu_torch import tensor as tensor_mod
from bucketeer_tpu_torch.codec import cxd
from bucketeer_tpu_torch.codec import encoder, rate, t1
from bucketeer_tpu_torch.kernels.fused_t1 import (MQ_ROW_BYTES, fused_t1,
                                                  max_syms, mq_capacity)


class _Sink:
    """A metrics sink that keeps the counters only."""

    def __init__(self):
        self.counters = {}

    def record(self, *args, **kwargs):
        pass

    def record_overlap(self, *args, **kwargs):
        pass

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


def _objects_run_device_mq(blocks_dev, nbps, floors, bandnames, hs, ws,
                           frac_bits):
    """The fused path's Tier-1 as objects: each launch group's outputs through
    ``cxd.assemble_mq_blocks``; a block in no group codes nothing."""
    out = [t1.CodedBlock(b"", 0) for _ in range(len(nbps))]
    syms = nbytes = passes = 0
    for L, idxs, args in cxd._group_launches(blocks_dev, nbps, floors,
                                             bandnames, hs, ws):
        rows, snaps, dlen, dh, dl, cur, _ = cxd.fused_t1(L, frac_bits,
                                                         *args)
        snaps, dlen, dh, dl, cur = (x.cpu().numpy()
                                    for x in (snaps, dlen, dh, dl, cur))
        need = -(-(dlen + 1) // MQ_ROW_BYTES) * (dlen > 0)
        payload, row_offs = cxd._fetch_block_rows(
            rows, need, mq_capacity(max_syms(L)) // MQ_ROW_BYTES,
            MQ_ROW_BYTES)
        dist = (dh.astype(np.float64) + dl.astype(np.float64)) / 4.0
        for i, blk in zip(idxs, cxd.assemble_mq_blocks(
                nbps[idxs], floors[idxs], snaps, dlen, dist, payload,
                row_offs)):
            out[int(i)] = blk
            passes += len(blk.passes)
        syms += int(cur.sum())
        nbytes += int(dlen.sum())
    return cxd.MqDeviceResult(out, syms, nbytes, 0.0, 0.0, 0.0, passes)


def _as_tuples(blocks):
    return [(b.data, b.n_bitplanes,
             [(p.pass_type, p.bitplane, p.cum_length, p.dist_reduction)
              for p in b.passes]) for b in blocks]


def _fake_kernel(seed):
    """A stand-in for ``fused_t1`` with outputs chosen to reach the
    assembly's edges: per block a nondecreasing snapshot run, and a
    stream length that is 0, ends exactly on a row (the pre-byte and
    the data fill whole rows), or anything up to the snapshots' end."""
    rng = np.random.default_rng(seed)

    def kernel(L, frac, blocks, nbps, floors, cls, hs, ws):
        n = blocks.shape[0]
        cap = mq_capacity(max_syms(L))
        snaps = np.cumsum(rng.integers(0, 90, (n, L * 3)), 1).reshape(
            n, L, 3).astype(np.int32)
        kind = rng.integers(0, 4, n)
        dlen = np.where(kind == 0, 0, np.where(
            kind == 1, MQ_ROW_BYTES * rng.integers(1, 4, n) - 1,
            rng.integers(1, snaps[:, -1, -1] + 2)))
        dh = rng.normal(0, 50, (n, L, 3)).astype(np.float32)
        dl = rng.normal(0, 1, (n, L, 3)).astype(np.float32)
        rows = rng.integers(0, 256, (n * cap // MQ_ROW_BYTES, MQ_ROW_BYTES),
                            dtype=np.uint8)
        cur = np.zeros(n, np.int32)
        return tuple(torch.as_tensor(x) for x in (
            rows, snaps, dlen.astype(np.int32), dh, dl, cur,
            dlen.astype(np.int32)))
    return kernel


def _fake_chunk(seed, n=48):
    """Plane depths that fill the L = 8, 16 and 32 groups, nonzero
    floors, and dead blocks (no planes, or floored away)."""
    rng = np.random.default_rng(seed)
    nbps = rng.integers(0, 31, n).astype(np.int32)
    floors = np.where(rng.random(n) < 0.4, rng.integers(0, 6, n),
                      0).astype(np.int32)
    nbps[:3] = (0, 4, 2)
    floors[:3] = (0, 4, 5)              # dead: nothing, floored, floored
    nbps[3:9] = (8, 16, 17, 30, 9, 1)
    floors[3:9] = 0
    floors = np.minimum(floors, nbps)
    bands = ["LL", "HL", "LH", "HH"] * (n // 4)
    sizes = np.full(n, 64, np.int32)
    return (torch.zeros((n, 64, 64), dtype=torch.int32), nbps, floors,
            bands, sizes, sizes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_columns_equal_assemble_mq_blocks(monkeypatch, seed):
    """Every block's bytes, plane count and passes, and the result's
    totals, over L = 8, 16 and 32 groups in one chunk."""
    monkeypatch.setattr(cxd, "fused_t1", _fake_kernel(seed))
    chunk = _fake_chunk(seed)
    got = cxd.run_device_mq(*chunk, 0)
    monkeypatch.setattr(cxd, "fused_t1", _fake_kernel(seed))
    ref = _objects_run_device_mq(*chunk, 0)
    groups, _ = cxd._eff_groups(chunk[1], chunk[2])
    assert {L for L, _ in groups} == {8, 16, 32}
    assert _as_tuples(got.cols.blocks()) == _as_tuples(ref.blocks)
    assert (got.total_syms, got.total_bytes, got.passes) == \
        (ref.total_syms, ref.total_bytes, ref.passes)
    lens = np.diff(got.cols.data_off)
    assert 0 in lens[np.asarray(got.cols.nbps) > 0]
    assert ((lens + 1) % MQ_ROW_BYTES == 0).any()
    assert len(got.cols.data) == got.total_bytes


class _Replay:
    """``cxd.fused_t1`` that runs the plain kernel on the first pass and
    hands back the same outputs, launch for launch, after ``rewind``:
    the two assemblies of one comparison pay for the plain kernel once."""

    def __init__(self):
        self.seen = []
        self.queue = None

    def __call__(self, L, *args):
        if self.queue is None:
            self.seen.append((L, fused_t1(L, *args)))
            return self.seen[-1][1]
        want, out = self.queue.pop(0)
        assert want == L
        return out

    def rewind(self):
        self.queue = list(self.seen)


def _both_assemblies(monkeypatch, *args):
    """One chunk through the columns and through the objects."""
    replay = _Replay()
    monkeypatch.setattr(cxd, "fused_t1", replay)
    got = cxd.run_device_mq(*args)
    replay.rewind()
    ref = _objects_run_device_mq(*args)
    assert not replay.queue
    return got, ref


def _block_chunk(seed, n, planes, frac, density):
    """``n`` blocks of up to ``planes`` coded planes above ``frac``
    fractional bits, one of them all zero and one floored away."""
    rng = np.random.default_rng(seed)
    mags = (rng.random((n, 64, 64)) < density) * rng.integers(
        0, 1 << (planes + frac), (n, 64, 64))
    blocks = mags * np.where(rng.random((n, 64, 64)) < 0.5, -1, 1)
    blocks[1] = 0
    nbps = np.array([int(np.abs(b).max() >> frac).bit_length()
                     for b in blocks], np.int32)
    floors = np.where(np.arange(n) % 3 == 0, 1, 0).astype(np.int32)
    floors[2] = nbps[2]
    floors = np.minimum(floors, nbps)
    sizes = rng.integers(1, 65, n).astype(np.int32)
    return (torch.as_tensor(blocks.astype(np.int32)), nbps, floors,
            ["LL", "HL", "LH", "HH"] * (n // 4), sizes,
            sizes[::-1].copy(), frac)


def test_plain_kernel_chunk_equals_objects(monkeypatch):
    """The fused Tier-1's plain version on blocks with fractional bits
    and partial extents: the columns are the objects' numbers, dead
    blocks included."""
    got, ref = _both_assemblies(monkeypatch, *_block_chunk(11, 8, 5, 5, 0.1))
    assert _as_tuples(got.cols.blocks()) == _as_tuples(ref.blocks)
    assert not ref.blocks[1].passes and not ref.blocks[2].passes
    assert got.passes == ref.passes > 0


def test_group_assembly_refuses_what_does_not_fit():
    """The native call is not made on depths outside 1..L or unlike the
    columns' pass ranges, nor on streams past their fetched rows."""
    nbps = np.array([5, 3], np.int32)
    floors = np.zeros(2, np.int32)
    idxs = np.arange(2)
    snaps = np.zeros((2, 8, 3), np.int32)
    dists = np.zeros((2, 8, 3))
    payload = np.zeros((2, MQ_ROW_BYTES), np.uint8)
    rows = np.array([0, 1, 2])
    full = MQ_ROW_BYTES - 1          # the pre-byte and this fill a row
    good = (idxs, np.array([5, 3]), snaps, np.array([full, 10]), dists,
            payload, rows)
    for bad in ({1: np.array([5, 4])}, {1: np.array([9, 3])},
                {3: np.array([full + 1, 10])}, {5: payload[:1]}):
        args = list(good)
        for k, v in bad.items():
            args[k] = v
        with pytest.raises(ValueError, match="launch group"):
            cxd.assemble_group_columns(cxd._chunk_columns(nbps, floors),
                                       np.zeros(2, np.int64), *args)
    cxd.assemble_group_columns(cxd._chunk_columns(nbps, floors),
                               np.zeros(2, np.int64), *good)


def test_ragged_ranges_equal_the_loop():
    rng = np.random.default_rng(3)
    starts = rng.integers(0, 1000, 40)
    lens = rng.integers(0, 7, 40)
    lens[[0, 9, 39]] = 0
    want = np.concatenate([np.arange(s, s + n) for s, n in
                           zip(starts, lens)])
    assert np.array_equal(cxd.ragged_ranges(starts, lens), want)
    assert cxd.ragged_ranges([], []).shape == (0,)


@dataclasses.dataclass
class _Layout:
    P: int


@dataclasses.dataclass
class _Stats:
    layout: _Layout
    sigd: np.ndarray
    refd: np.ndarray


@pytest.fixture(scope="module")
def lossy_chunks():
    """Two chunks of the stand-in kernel's output over L = 8, 16 and 32
    groups, each as (columns, objects, the front-end's exact plane
    sums: float32, some negative or zero)."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        for seed in (8, 9):
            chunk = _fake_chunk(seed)
            mp.setattr(cxd, "fused_t1", _fake_kernel(seed))
            got = cxd.run_device_mq(*chunk, 7)
            mp.setattr(cxd, "fused_t1", _fake_kernel(seed))
            ref = _objects_run_device_mq(*chunk, 7)
            rng = np.random.default_rng(seed)
            n, P = len(chunk[1]), 32
            stats = _Stats(_Layout(P), *(
                (rng.normal(1e3, 4e3, (n, P)) * (rng.random((n, P)) < 0.9)
                 ).astype(np.float32) for _ in range(2)))
            out.append((got.cols, ref.blocks, stats))
    return out


def _corrected(chunk):
    cols, objs, stats = chunk
    cols = dataclasses.replace(cols, dist=cols.dist.copy())
    objs = copy.deepcopy(objs)
    encoder._correct_distortions(objs, stats)
    encoder._correct_distortions_columns(cols, stats)
    return cols, objs


def test_correct_distortions_twin_is_float_for_float(lossy_chunks):
    """The exact plane sums scale the same passes by the same floats."""
    for chunk in lossy_chunks:
        cols, objs = _corrected(chunk)
        want = np.array([p.dist_reduction for b in objs for p in b.passes],
                        np.float64)
        assert len(want) == len(cols.dist) > 500
        assert np.array_equal(cols.dist, want)
        assert not np.array_equal(cols.dist, chunk[0].dist)
        assert [(p.pass_type, p.bitplane, p.cum_length) for b in objs
                for p in b.passes] == list(zip(
                    cols.types.tolist(), cols.planes.tolist(),
                    cols.cum_len.tolist()))


@pytest.mark.parametrize("corrected", [False, True])
def test_cut_slope_twin_is_the_same_value(lossy_chunks, corrected):
    """Over two chunks' columns with the encode's block weights, at
    targets that bind, that fit everything and none."""
    parts = [_corrected(c) if corrected else c[:2] for c in lossy_chunks]
    objs = [b for _, o in parts for b in o]
    weights = np.random.default_rng(10).random(len(objs)) * 3 + 0.1
    total = sum(len(b.data) for b in objs)
    for target in (None, 1.0, total * 0.02, total * 0.1, total * 0.5,
                   total * 0.9, total * 2.0):
        want = rate.cut_slope(objs, weights, target)
        got = encoder._cut_slope_columns([c for c, _ in parts], weights,
                                         target)
        assert got == want, target
        if target is not None and 1.0 < target <= total * 0.1:
            assert got > 0.0


def _image(h, w, comps, depth, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    top = (1 << depth) - 1
    base = ((np.sin(x / 7.0) + np.cos(y / 5.0)) * 0.23 * top + top / 2
            + rng.normal(0, top / 24, (h, w))).clip(0, top)
    img = np.stack([np.roll(base, 3 * c, c % 2) for c in range(comps)], -1)
    return img.astype(np.uint8 if depth <= 8 else np.uint16)


def _recipe(lossless, **over):
    return dataclasses.replace(encoder.EncodeParams.kakadu_recipe(
        lossless, None if lossless else 3.0), device_mq=True, **over)


def _encode_both(monkeypatch, img, depth, params):
    """The file from the columns and the parent's file (the objects
    path), with each one's sink counters."""
    out = []
    replay = _Replay()
    monkeypatch.setattr(cxd, "fused_t1", replay)
    for drive in (cxd.run_device_mq, _objects_run_device_mq):
        monkeypatch.setattr(cxd, "run_device_mq", drive)
        if out:
            replay.rewind()
        sink = _Sink()
        encoder.set_metrics_sink(sink)
        try:
            out.append((encoder.encode_jp2(img, depth, params,
                                           device="cpu"), sink.counters))
        finally:
            encoder.set_metrics_sink(None)
    return out


@pytest.mark.parametrize("case", ["rgb8", "rgb16_partial_tiles"])
def test_lossless_encode_equals_the_objects_path(monkeypatch, case):
    img, depth, params = {
        "rgb8": (_image(64, 64, 3, 8, 1), 8, _recipe(True, levels=2)),
        "rgb16_partial_tiles": (_image(40, 36, 3, 16, 2), 16,
                                _recipe(True, levels=3, tile_size=32)),
    }[case]
    (got, counters), (want, _) = _encode_both(monkeypatch, img, depth,
                                              params)
    assert got == want
    assert counters["encode.t1_passes"] > 0
    assert counters.get("encode.t1_blocks_materialized", 0) == 0


def test_rate3_encode_with_a_floor_rerun_equals_the_objects_path(
        monkeypatch):
    """-rate 3 with the first floor estimate far too tight, so the floors
    are estimated again and Tier-1 runs twice: the columns' correction
    and cut slope decide as the objects' do."""
    real = rate.estimate_floors

    def tight_first(*args):
        *args, margin = args
        # The first attempt's margin is 3.
        return real(*args, margin / 40.0 if margin == 3.0 else margin)

    monkeypatch.setattr(rate, "estimate_floors", tight_first)
    img = _image(64, 64, 3, 8, 3)
    (got, counters), (want, ref_counters) = _encode_both(
        monkeypatch, img, 8, _recipe(False, levels=3))
    assert got == want
    assert counters["encode.floor_reruns"] >= 1
    assert counters == ref_counters
    assert counters.get("encode.t1_blocks_materialized", 0) == 0


def test_tensor_container_and_the_materialised_count():
    """The tensor codec's card backend materialises the columns into the
    blocks its container reads; its container is the host coder's."""
    x = np.random.default_rng(12).integers(-6, 6, (16, 64)).astype(
        np.int8)
    sink = _Sink()
    tensor_mod.set_metrics_sink(sink)
    try:
        blob = tensor_mod.encode_tensor(x, device="device",
                                        torch_device="cpu")
    finally:
        tensor_mod.set_metrics_sink(None)
    assert blob == tensor_mod.encode_tensor(x, device="host")
    assert sink.counters["encode.t1_blocks_materialized"] == \
        sink.counters["tensor.encode_blocks"] > 0
