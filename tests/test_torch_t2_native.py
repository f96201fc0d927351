"""The native host back half (codec/t2_native.py, csrc/host_t2.cpp)
against its plain version (encoder._plain_finish: codec/rate.py,
codec/t2.py, encoder._tile_parts): the same codestream, byte for byte,
after the same number of Tier-2 builds, on the CPU.

Each image is encoded once (the coded blocks depend on the tiling, the
levels and the rate, not on the back half's options); ``_finish`` and
the plain version then run on the blocks ``_finish`` was given, under
each set of back-half options. ``_fit_to_target`` is wrapped to count
each one's builds."""
import dataclasses

import numpy as np
import pytest
import torch

from bucketeer_tpu_torch import obs
from bucketeer_tpu_torch.codec import codestream as cs
from bucketeer_tpu_torch.codec import encoder, rate, t1, t2_native
from bucketeer_tpu_torch.obs.trace import Recorder

P = encoder.EncodeParams


class _Sink:
    """The encoder's metrics sink, keeping the counters only."""

    def __init__(self):
        self.counters = {}

    def record(self, *args, **kwargs):
        pass

    def record_overlap(self, *args, **kwargs):
        pass

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


def _image(h, w, comps=3, depth=8, seed=0, noise=1 / 32):
    """A smooth scan-like image with grain: every band gets passes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    top = (1 << depth) - 1
    base = ((np.sin(x / 37.0) + np.cos(y / 23.0)) * 0.23 * top + top / 2
            + rng.normal(0, top * noise, (h, w))).clip(0, top)
    dtype = np.uint8 if depth <= 8 else np.uint16
    if comps == 1:
        return base.astype(dtype)
    return np.stack([base, np.roll(base, 5, 0), np.roll(base, 9, 1)],
                    -1).astype(dtype)


def _flat_corner(h, w, seed):
    img = _image(h, w, seed=seed)
    img[:320, :320] = 77        # whole code-blocks with no pass
    return img


def _small(lossless):
    """Three levels, ragged tiles of 64, three layers; the back-half
    options are set per test."""
    return P(lossless=lossless, levels=3, tile_size=64, n_layers=3,
             rate=None if lossless else 2.0,
             base_delta=1.0 if lossless else 2.0)


# name -> (image, bit depth, params; None: the Kakadu recipe at -rate 3).
_ENCODES = {
    "rgb1024": (lambda: _image(1024, 1024, noise=1 / 64), 8, None),
    "gray16": (lambda: _image(384, 320, comps=1, depth=16, seed=1), 16,
               None),
    "ragged": (lambda: _flat_corner(700, 1000, seed=2), 8, None),
    "small": (lambda: _image(160, 200, seed=3), 8, _small),
}


@pytest.fixture(scope="module")
def encoded():
    """``encoded(name, lossless)``: the arguments ``_finish`` got when
    that image was encoded, after checking that the encode returned what
    ``_finish`` did."""
    cache = {}

    def get(name, lossless):
        key = (name, lossless)
        if key not in cache:
            make, depth, params = _ENCODES[name]
            params = (params(lossless) if params is not None
                      else P.kakadu_recipe(lossless, 3.0))
            seen = {}
            real = encoder._finish

            def grab(*args, columns=None):
                # The host coders' blocks: objects, no columns.
                assert columns is None
                seen["args"] = args
                seen["out"] = real(*args)
                return seen["out"]

            # One intra-op thread: with torch's default count, beside the
            # suite's other workers, each of these encodes took 30-60 s.
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            encoder._finish = grab
            try:
                code = encoder.encode_array(make(), depth, params,
                                            device="cpu")
            finally:
                encoder._finish = real
                torch.set_num_threads(threads)
            assert code == seen["out"]
            cache[key] = seen["args"]
        return cache[key]
    return get


@pytest.fixture
def twin(monkeypatch):
    """``twin(args, **options)``: both back halves on ``_finish``'s
    arguments, with the back-half options replaced; checks the bytes,
    the builds and the native build counter, and returns the builds,
    the counters and the codestream."""
    builds = []
    real_fit = encoder._fit_to_target

    def fit(build, target):
        builds.append(0)

        def counted(budget):
            builds[-1] += 1
            return build(budget)
        return real_fit(counted, target)

    monkeypatch.setattr(encoder, "_fit_to_target", fit)

    def run(args, **options):
        args = list(args)
        args[1] = dataclasses.replace(args[1], **options)
        builds.clear()
        sink = _Sink()
        encoder.set_metrics_sink(sink)
        try:
            native = encoder._finish(*args)
        finally:
            encoder.set_metrics_sink(None)
        plain = encoder._plain_finish(*args)
        assert native == plain
        assert builds[0] == builds[1]
        assert sink.counters.get("encode.t2_native") == builds[0]
        return {"builds": builds[0], "counters": sink.counters,
                "code": native}
    return run


@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "rate3"])
def test_kakadu_recipe_1024_rgb(encoded, twin, lossless):
    """The upstream recipe at 1024x1024 RGB; at -rate 3 the byte-target
    loop rebuilds at least once."""
    seen = twin(encoded("rgb1024", lossless))
    if lossless:
        assert seen["builds"] == 1
    else:
        assert seen["builds"] >= 2
        assert seen["counters"].get("encode.t2_rebuilds") == \
            seen["builds"] - 1


@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "rate3"])
def test_gray16(encoded, twin, lossless):
    twin(encoded("gray16", lossless))


@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "rate3"])
def test_sides_not_multiples_of_the_tile(encoded, twin, lossless):
    """700x1000 on 512 tiles, with a flat corner."""
    twin(encoded("ragged", lossless))


@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "rate3"])
def test_flat_region_blocks_without_passes(encoded, twin, lossless):
    args = encoded("ragged", lossless)
    assert any(not b.passes for b in args[3])
    twin(args, n_layers=2, progression=cs.PROG_LRCP)


@pytest.mark.parametrize("progression", [
    cs.PROG_LRCP, cs.PROG_RLCP, cs.PROG_RPCL, cs.PROG_PCRL, cs.PROG_CPRL],
    ids=["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "rate2"])
def test_every_progression(encoded, twin, progression, lossless):
    """Ragged tiles of 64, precincts, SOP/EPH, PLT and R tile-parts
    (which split only the resolution-major orders)."""
    twin(encoded("small", lossless), progression=progression,
         precincts=((128, 128), (128, 128)), use_sop=True, use_eph=True,
         gen_plt=True, tparts_r=True)


@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "rate2"])
def test_markers_and_parts_off(encoded, twin, lossless):
    """No precincts, no SOP or EPH, no PLT, one tile-part per tile."""
    twin(encoded("small", lossless), progression=cs.PROG_RPCL,
         n_layers=4)


@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "rate3"])
def test_one_layer(encoded, twin, lossless):
    twin(encoded("gray16", lossless), n_layers=1)


def test_allocation_equals_rate_allocate():
    """t2_allocate's layer boundaries are rate.allocate's, with a budget
    and without, on blocks with equal slopes, collinear points, no
    passes, passes that add no bytes and passes that add no
    distortion."""
    rng = np.random.default_rng(7)
    coded = []
    for i in range(60):
        n = int(rng.integers(0, 20))
        data = bytes(int(rng.integers(0, 400)))
        lens = np.minimum(np.cumsum(rng.integers(0, 40, n)), len(data))
        dists = rng.choice([0.0, 1.0, 2.5], n) * rng.random(n) * 100
        if i % 7 == 0:
            dists[:] = 3.0
        coded.append(t1.CodedBlock(
            data, 8, [t1.PassInfo(2, 0, int(ln), float(d))
                      for ln, d in zip(lens, dists)]))
    weights = list(rng.random(len(coded)) * 4 + 0.5)
    plan = t2_native.PacketPlan(*(np.zeros(1, np.int32),) * 5,
                                np.zeros((0, 3), np.int32),
                                np.zeros(1, np.int32), [])
    # Collinear truncation points: the hull keeps only the last of them.
    line = t1.CodedBlock(bytes(40), 8, [t1.PassInfo(2, 0, 10 * k, 3.0)
                                        for k in range(1, 5)])
    cases = [(coded, weights, (None, 50.0, 400.0, 1e9)),
             ([line], [1.0], (None, 25.0, 45.0))]
    for blocks, wts, budgets in cases:
        native = t2_native.Tier2(blocks, wts, plan, 4, False, False)
        for budget in budgets:
            passes, nbytes = native.allocate(budget)
            ref = rate.allocate(blocks, wts, 4, budget)
            assert [list(zip(p.tolist(), b.tolist()))
                    for p, b in zip(passes, nbytes)] == \
                [[tuple(x) for x in a.boundaries] for a in ref]


def test_write_rejects_boundaries_of_another_shape():
    blk = t1.CodedBlock(b"\x01\x02", 8, [t1.PassInfo(2, 0, 2, 1.0)])
    plan = t2_native.PacketPlan(*(np.zeros(1, np.int32),) * 5,
                                np.zeros((0, 3), np.int32),
                                np.zeros(1, np.int32), [])
    native = t2_native.Tier2([blk], [1.0], plan, 3, False, False)
    passes, nbytes = native.allocate(None)
    assert passes.tolist() == [[0, 0, 1]] and nbytes.tolist() == [[0, 0, 2]]
    with pytest.raises(ValueError, match="passes"):
        native.write(passes[:, :2], nbytes)
    with pytest.raises(ValueError, match="nbytes"):
        native.write(passes, nbytes.astype(np.int32))
    with pytest.raises(ValueError, match="weights"):
        t2_native.Tier2([blk], [1.0, 2.0], plan, 3, False, False)


def test_tier2_span_is_native(encoded, twin):
    prev = obs.get_recorder()
    rec = Recorder()
    obs.install(rec)
    try:
        seen = twin(encoded("rgb1024", False))
    finally:
        obs.install(prev)
    spans = rec.snapshot()
    tier2 = [s for s in spans if s["name"] == "encode.tier2"]
    plan = [s for s in spans if s["name"] == "encode.t2_plan"]
    assert len(tier2) == 1 and len(plan) == 1
    assert tier2[0]["attrs"]["path"] == "native"
    assert tier2[0]["attrs"]["builds"] == seen["builds"]
    assert tier2[0]["attrs"]["packets"] > 0
    assert plan[0]["parent_id"] == tier2[0]["span_id"]
