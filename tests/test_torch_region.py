"""Region reads through the port (on the CPU): the exact crop of the
port's own full decode for both wavelets, with reduce and layers,
indexed (PLT and tag-tree walk) and sequential; the same code-blocks and
MQ decisions as the JAX decoder's region read; region plans equal to
JAX's; the device inverse against JAX's on the same half-magnitudes; and
typed rejection of bad regions."""
import dataclasses

import numpy as np
import pytest

from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu.codec.decode import build_index as j_build_index
from bucketeer_tpu.codec.decode import decode as j_decode
from bucketeer_tpu.codec.decode import decoder as j_decoder
from bucketeer_tpu.codec.decode import device as j_device
from bucketeer_tpu.codec.encoder import EncodeParams
from bucketeer_tpu.server.metrics import Metrics
from bucketeer_tpu_torch.codec.decode import (InvalidParam, build_index,
                                              decode, set_metrics_sink)
from bucketeer_tpu_torch.codec.decode import device as t_device
from bucketeer_tpu_torch.codec.decode import index as sindex
from bucketeer_tpu_torch.codec.decode import parser


def _img(seed, h, w, comps=3, depth=8):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if depth <= 8 else np.uint16
    shape = (h, w) if comps == 1 else (h, w, comps)
    return rng.integers(0, 1 << depth, shape).astype(dtype)


def _dec(data, **kw):
    return decode(data, device="cpu", **kw)


REGIONS = [(0, 0, 33, 33), (17, 9, 40, 23), (31, 37, 9, 50),
           (60, 60, 500, 500)]


@pytest.mark.parametrize("comps,depth,lossless,tile,levels", [
    (3, 8, True, 64, 3),          # RGB lossless, multi-tile
    (3, 8, False, 64, 3),         # RGB lossy 9/7, multi-tile
    (1, 8, True, None, 3),        # grayscale single tile
    (1, 16, True, 96, 2),         # 16-bit, straddling 96-tile grid
    (3, 8, False, None, 4),       # lossy single tile, deeper pyramid
])
def test_region_is_exact_crop_of_full(comps, depth, lossless, tile,
                                      levels):
    img = _img(comps + depth + levels, 72, 80, comps, depth)
    data = j_encoder.encode_jp2(img, depth, EncodeParams(
        lossless=lossless, levels=levels, tile_size=tile, base_delta=2.0))
    full = _dec(data)
    if lossless:
        np.testing.assert_array_equal(full, img)
    for region in REGIONS:
        x, y, w, h = region
        got = _dec(data, region=region)
        want = full[y:min(y + h, 72), x:min(x + w, 80)]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=str(region))


@pytest.mark.parametrize("lossless", [True, False])
def test_region_with_reduce_and_layers(lossless):
    img = _img(7, 80, 72)
    data = j_encoder.encode_jp2(img, 8, EncodeParams(
        lossless=lossless, levels=3, tile_size=64, n_layers=3,
        base_delta=2.0, rate=None if lossless else 3.0))
    for reduce, layers in ((1, None), (2, None), (0, 1), (1, 2)):
        full = _dec(data, reduce=reduce, layers=layers)
        s = 1 << reduce
        for x, y, w, h in [(17, 9, 40, 23), (64, 60, 48, 32)]:
            got = _dec(data, region=(x, y, w, h), reduce=reduce,
                       layers=layers)
            want = full[y // s:-(-min(y + h, 80) // s),
                        x // s:-(-min(x + w, 72) // s)]
            np.testing.assert_array_equal(got, want)


def _counters(setter, run):
    sink = Metrics()
    setter(sink)
    try:
        out = run()
    finally:
        setter(None)
    return out, sink.report()


@pytest.mark.parametrize("lossless", [True, False])
def test_region_blocks_and_decisions_equal_jax(lossless):
    """The same code-blocks and MQ decisions as the JAX decoder's read
    (a halo or window slip shows here first), indexed and not; the
    pixels equal (lossless) or are within +-1 (lossy) of JAX's."""
    img = _img(13, 96, 96)
    params = dataclasses.replace(
        EncodeParams.kakadu_recipe(lossless=lossless, rate=3.0),
        tile_size=64, levels=3)
    data = j_encoder.encode_jp2(img, 8, params)
    region = (40, 20, 50, 60)
    for indexed in (False, True):
        got, g_rep = _counters(set_metrics_sink, lambda: _dec(
            data, region=region, reduce=1,
            index=build_index(data) if indexed else None))
        ref, r_rep = _counters(j_decoder.set_metrics_sink, lambda: j_decode(
            data, region=region, reduce=1,
            index=j_build_index(data) if indexed else None))
        for name in ("decode.region_blocks", "decode.mq_symbols",
                     "decode.blocks"):
            assert g_rep["counters"][name] == r_rep["counters"][name] > 0
        assert g_rep["counters"].get("decode.packets_skipped") == \
            r_rep["counters"].get("decode.packets_skipped")
        diff = np.abs(got.astype(np.int64) - ref)
        assert diff.max() <= (0 if lossless else 1)


def test_kakadu_recipe_every_tile_through_the_index():
    """The reference recipe, lossy: every aligned tile of a multi-tile
    stream equals the full decode's crop through the indexed path."""
    img = _img(17, 96, 96)
    params = dataclasses.replace(
        EncodeParams.kakadu_recipe(lossless=False, rate=3.0),
        tile_size=64, levels=3)
    data = j_encoder.encode_jp2(img, 8, params)
    idx = build_index(data)
    assert idx.source == "plt"
    full = _dec(data)
    for y in range(0, 96, 64):
        for x in range(0, 96, 64):
            got = _dec(data, region=(x, y, 64, 64), index=idx)
            np.testing.assert_array_equal(got, full[y:y + 64, x:x + 64])


def test_plt_and_walk_indexes_equal_jax():
    """Both index builds land on the JAX package's offsets, and on each
    other's."""
    img = _img(19, 80, 80)
    params = dataclasses.replace(
        EncodeParams.kakadu_recipe(lossless=True), tile_size=64,
        levels=3)
    data = j_encoder.encode_jp2(img, 8, params)
    idx = build_index(data)
    ref = j_build_index(data)
    assert (idx.source, idx.n_packets) == (ref.source, ref.n_packets)
    assert idx.source == "plt"
    assert idx.packets == ref.packets and idx.tile_spans == ref.tile_spans
    ps = parser.parse(bytes(data), collect_index=True)
    assert idx.packets == ps.packet_index
    # A non-sequential Zplt sends the build to the walk path.
    bad = bytearray(data)
    pos = bytes(bad).find(b"\xff\x58")
    bad[pos + 4] = 7
    walk = build_index(bytes(bad))
    assert walk.source == "walk" == j_build_index(bytes(bad)).source
    assert walk.packets == idx.packets
    full = _dec(bytes(bad))
    np.testing.assert_array_equal(
        _dec(bytes(bad), region=(5, 5, 40, 40), index=walk),
        full[5:45, 5:45])
    sk = sindex.skeleton(idx)
    assert (sk.width, sk.height, sk.levels, sk.reversible, sk.tiles) == \
        (80, 80, 3, True, [])
    assert idx.nbytes < max(4 * len(data), 1 << 20)


@pytest.mark.parametrize("progression", [0, 1, 2, 3, 4])
def test_indexed_equals_sequential_all_progressions(progression):
    img = _img(23 + progression, 64, 64)
    data = j_encoder.encode_jp2(img, 8, EncodeParams(
        lossless=True, levels=2, tile_size=64, n_layers=2,
        progression=progression, gen_plt=True))
    idx = build_index(data)
    for x, y, w, h in [(0, 0, 30, 30), (41, 33, 23, 31)]:
        a = _dec(data, region=(x, y, w, h))
        b = _dec(data, region=(x, y, w, h), index=idx)
        np.testing.assert_array_equal(a, img[y:y + h, x:x + w])
        np.testing.assert_array_equal(b, a)


def test_indexed_region_skips_packets():
    img = _img(29, 128, 128)
    data = j_encoder.encode_jp2(img, 8, dataclasses.replace(
        EncodeParams.kakadu_recipe(lossless=True), tile_size=64,
        levels=3))
    idx = build_index(data)
    _, rep = _counters(set_metrics_sink, lambda: _dec(
        data, region=(0, 0, 16, 16), index=idx))
    skipped = rep["counters"]["decode.packets_skipped"]
    assert skipped > idx.n_packets / 2
    assert rep["stages"]["decode.t2_parse"]["items"] + skipped == \
        idx.n_packets


# --- plans and the device inverse against JAX ----------------------------

def _delta(lvl, name):
    return 0.25 * lvl + {"LL": 0.5, "HL": 1.0, "LH": 1.5, "HH": 2.0}[name]


@pytest.mark.parametrize("rh,rw,levels,win", [
    (64, 64, 3, (0, 64, 0, 64)), (64, 64, 3, (9, 23, 40, 41)),
    (37, 29, 2, (5, 30, 0, 7)), (8, 5, 3, (1, 2, 4, 5)),
    (512, 512, 6, (100, 356, 7, 300))])
@pytest.mark.parametrize("reversible", [True, False])
def test_plans_equal_jax(rh, rw, levels, win, reversible):
    args = (rh, rw, 3, levels, reversible, 8, True, _delta)
    assert dataclasses.astuple(t_device.make_inverse_plan(*args)) == \
        dataclasses.astuple(j_device.make_inverse_plan(*args))
    assert dataclasses.astuple(t_device.make_region_plan(*args, *win)) == \
        dataclasses.astuple(j_device.make_region_plan(*args, *win))
    assert t_device.halo(reversible) == j_device.halo(reversible)


def _hvals(seed, plan, batch):
    """Random signed half-magnitudes, odd like a decoded block's, with
    negative odd values throughout (the arithmetic shifts' corner)."""
    rng = np.random.default_rng(seed)
    mag = rng.integers(0, 1 << 9, (batch, plan.n_comps, plan.tile_h,
                                   plan.tile_w)) * 2 + 1
    zero = rng.random(mag.shape) < 0.3
    sign = np.where(rng.random(mag.shape) < 0.5, -1, 1)
    return np.where(zero, 0, sign * mag).astype(np.int32)


@pytest.mark.parametrize("reversible,mct,h,w,levels", [
    (True, True, 40, 36, 3), (True, False, 9, 7, 2),
    (False, True, 40, 36, 3), (False, False, 17, 5, 2)])
def test_run_inverse_against_jax(reversible, mct, h, w, levels):
    """Same half-magnitudes through both inverses: 5/3 + RCT exact, 9/7
    + ICT within +-1 sample; and a region of the same plan is the exact
    crop of the port's full inverse."""
    n_comps = 3 if mct else 1
    args = (h, w, n_comps, levels, reversible, 8, mct, _delta)
    plan = t_device.make_inverse_plan(*args)
    hv = _hvals(h * w + levels, plan, 2)
    got = t_device.run_inverse(plan, hv, "cpu")
    ref = np.asarray(j_device.run_inverse(
        j_device.make_inverse_plan(*args), hv))
    assert got.shape == ref.shape == (2, h, w, n_comps)
    assert np.abs(got.astype(np.int64) - ref).max() <= (
        0 if reversible else 1)
    win = (h // 3, h - 1, w // 4, w)
    rplan = t_device.make_region_plan(*args, *win)
    origins = {(n, lv): (y0, x0) for n, lv, y0, x0, *_ in plan.slots}
    slots = [hv[0, :, origins[(n, lv)][0] + by0:origins[(n, lv)][0] + by1,
                origins[(n, lv)][1] + bx0:origins[(n, lv)][1] + bx1]
             for n, lv, by0, by1, bx0, bx1, _ in rplan.slots]
    region = t_device.run_region_inverse(rplan, slots, "cpu")
    if reversible:
        # The window's halo covers everything its samples depend on, so
        # the windowed synthesis equals the full inverse's crop.
        np.testing.assert_array_equal(
            region, got[0, win[0]:win[1], win[2]:win[3]])
    else:
        # The 9/7 path scatters the window into the full plane: the
        # samples equal a full inverse of the zero-filled plane's crop.
        sparse = np.zeros_like(hv[:1])
        for (n, lv, by0, by1, bx0, bx1, _), a in zip(rplan.slots, slots):
            y0, x0 = origins[(n, lv)]
            sparse[0, :, y0 + by0:y0 + by1, x0 + bx0:x0 + bx1] = a
        full = t_device.run_inverse(plan, sparse, "cpu")[0]
        np.testing.assert_array_equal(
            region, full[win[0]:win[1], win[2]:win[3]])


# --- malformed region parameters -----------------------------------------

@pytest.fixture(scope="module")
def gray_stream():
    img = _img(31, 64, 64, comps=1)
    return j_encoder.encode_jp2(img, 8, EncodeParams(
        lossless=True, levels=2, tile_size=64))


@pytest.mark.parametrize("region", [
    (-1, 0, 10, 10), (0, -3, 10, 10),         # negative origin
    (200, 0, 10, 10), (0, 200, 10, 10),       # origin beyond the image
    (0, 0, 0, 10), (0, 0, 10, 0),             # zero extent
    (0, 0, -5, 10),                           # negative extent
    ("a", 0, 10, 10), (1.5, 0, 10, 10),       # not integral
    (0, 0, 10), (None, None, None, None),     # wrong arity / type
])
def test_bad_region_raises_invalid_param(gray_stream, region):
    with pytest.raises(InvalidParam):
        _dec(gray_stream, region=region)


def test_region_reduce_beyond_levels_raises(gray_stream):
    with pytest.raises(InvalidParam):
        _dec(gray_stream, region=(0, 0, 8, 8), reduce=5)
    with pytest.raises(InvalidParam):
        _dec(gray_stream, region=(0, 0, 8, 8), reduce=5,
             index=build_index(gray_stream))
