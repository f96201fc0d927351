"""The host Tier-1 path on the CPU, held against the JAX package: the
front-end in mode "rows" (bit-plane packing), the payload plan, gather
and unpack, the host block coder (csrc/host_t1.cpp against the JAX
package's native library and the port's pure-Python coder), encodes in
mode "rows" and on straddling tile grids, merged front-end launches in
the scheduler, and the service's Tier-1 config keys."""
import threading

import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import codestream as cs
from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu.codec import frontend as j_frontend
from bucketeer_tpu.codec import pipeline as j_pipeline
from bucketeer_tpu.codec import t1_batch as j_t1_batch
from bucketeer_tpu.codec.quant import FRAC_BITS
from bucketeer_tpu_torch.codec import encoder as t_encoder
from bucketeer_tpu_torch.codec import frontend as t_frontend
from bucketeer_tpu_torch.codec import pipeline as t_pipeline
from bucketeer_tpu_torch.codec import t1 as t_t1
from bucketeer_tpu_torch.codec import t1_batch as t_t1_batch
from bucketeer_tpu_torch.engine import EncodeScheduler
from bucketeer_tpu_torch.server.metrics import Metrics


def _photo(seed, h, w, comps=3):
    """Scan-like 8-bit content: smooth structure plus sensor noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (0.47 + 0.31 * np.sin(x / 17.0) * np.cos(y / 13.0)) * 255
    img = base[..., None] + rng.normal(0, 8, (h, w, comps))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if comps == 1 else img


# --- the front-end in mode "rows" ------------------------------------------

def _frontends(lossless, tiles, args=None):
    """Mode "rows" front-end of both packages on the same tiles: (JAX
    rows, JAX stats, port rows, port stats, port plan)."""
    args = args or (128, 128, 3, 3, lossless, 8, 0.5, True)
    jp = j_pipeline.make_plan(*args)
    tp = t_pipeline.make_plan(*args)
    P = t_frontend.layout_for(tp).P
    frac = 0 if lossless else FRAC_BITS
    jrows, jstats = j_frontend._compiled_frontend(jp, P, "rows")(tiles)
    step = None if lossless else torch.as_tensor(t_pipeline._step_map(tp))
    trows, tstats = t_frontend._frontend_body(
        tp, P, frac, "rows", step, torch.as_tensor(tiles.astype(np.int32)))
    return (np.asarray(jrows), [np.asarray(a) for a in jstats],
            trows.numpy(), [t.numpy() for t in tstats], tp)


@pytest.mark.parametrize("lossless", [True, False])
def test_frontend_rows_equal_jax(lossless):
    """2 tiles of 128x128x3 at 3 levels. The packed rows (N * (P + 1),
    512) uint8 are exactly the JAX package's _pack_bits of the port's own
    coefficients (sign plane, then planes 0..P-1), and maxidx / newsig
    exactly their numpy recomputation. Against the JAX program:
    lossless, rows, maxidx and newsig are identical; lossy, the 9/7
    quantizer indices move by at most one on at most 0.1 % of samples
    (C.3, as tests/test_torch_transform.py allows), so only the bytes
    holding such a sample may differ. sigd / refd within rtol 1e-5
    (lossless; float32 sums in another order)."""
    tiles = np.stack([_photo(1, 128, 128), _photo(2, 128, 128)])
    jrows, jst, trows, tst, tp = _frontends(lossless, tiles)
    layout = t_frontend.layout_for(tp)
    P = layout.P
    n = 2 * layout.n_per_tile
    assert trows.dtype == np.uint8
    assert trows.shape == (n * (P + 1), 512)
    # The port's own blocks (the same body in mode "mq").
    frac = 0 if lossless else FRAC_BITS
    step = None if lossless else torch.as_tensor(t_pipeline._step_map(tp))
    blocks, _ = t_frontend._frontend_body(
        tp, P, frac, "mq", step, torch.as_tensor(tiles.astype(np.int32)))
    blocks = blocks.numpy()
    idx = np.abs(blocks.astype(np.int64)) >> frac
    want = [np.asarray(j_frontend._pack_bits(blocks < 0))]
    want += [np.asarray(j_frontend._pack_bits((idx >> p) & 1))
             for p in range(P)]
    np.testing.assert_array_equal(
        trows, np.stack(want, axis=1).reshape(-1, 512))
    np.testing.assert_array_equal(tst[0], idx.max(axis=(1, 2)))
    np.testing.assert_array_equal(
        tst[1][:, 0], ((idx != 0) & ((idx >> 1) == 0)).sum((1, 2)))
    if lossless:
        np.testing.assert_array_equal(trows, jrows)
        np.testing.assert_array_equal(tst[0], jst[0])       # maxidx
        np.testing.assert_array_equal(tst[1], jst[1])       # newsig
        np.testing.assert_allclose(tst[2], jst[2], rtol=1e-5)
        np.testing.assert_allclose(tst[3], jst[3], rtol=1e-5)
    else:
        assert np.abs(tst[0] - jst[0]).max() <= 1
        assert (trows != jrows).mean() <= 1e-3


def test_pack_bits_is_lsb_first():
    """Sample (y, x) goes to byte y*8 + x//8, bit x%8: bytes compared,
    not decoded planes."""
    bits = torch.zeros((2, 64, 64), dtype=torch.int64)
    bits[0, 0, 0] = 1            # byte 0, bit 0
    bits[0, 0, 9] = 1            # byte 1, bit 1
    bits[1, 3, 63] = 1           # byte 31, bit 7
    out = t_frontend._pack_bits(bits).numpy()
    want = np.zeros((2, 512), np.uint8)
    want[0, 0], want[0, 1], want[1, 31] = 1, 2, 128
    np.testing.assert_array_equal(out, want)
    rng = np.random.default_rng(3)
    rand = rng.integers(0, 2, (5, 64, 64))
    np.testing.assert_array_equal(
        t_frontend._pack_bits(torch.as_tensor(rand)).numpy(),
        np.asarray(j_frontend._pack_bits(rand)))


def test_resolve_stats_window_and_guard():
    """resolve_stats(tile_off, n_tiles) equals the JAX window of the
    same batch (nbps, newsig, block_base); a magnitude beyond the
    subband Mb raises ValueError in both packages."""
    tiles = np.stack([_photo(s, 64, 64) for s in (4, 5, 6)])
    args = (64, 64, 3, 2, True, 8, 0.5, True)
    jp = j_pipeline.make_plan(*args)
    tp = t_pipeline.make_plan(*args)
    jpend = j_frontend.dispatch_frontend(jp, tiles, mode="rows")
    tpend = t_frontend.dispatch_frontend(tp, tiles, mode="rows",
                                         device="cpu")
    whole = t_frontend.run_frontend(tp, tiles, device="cpu")
    np.testing.assert_array_equal(whole.nbps,
                                  j_frontend.run_frontend(jp, tiles).nbps)
    for off, n in ((0, None), (1, 2), (2, 1)):
        jr = jpend.resolve_stats(tile_off=off, n_tiles=n)
        tr = tpend.resolve_stats(tile_off=off, n_tiles=n)
        assert (tr.n_tiles, tr.block_base) == (jr.n_tiles, jr.block_base)
        np.testing.assert_array_equal(tr.nbps, jr.nbps)
        np.testing.assert_array_equal(tr.newsig, jr.newsig)
        assert tr.blocks is None and tr.rows is tpend.rows
    for pend in (jpend, tpend):
        pend.layout = type(pend.layout)(pend.layout.plan,
                                        pend.layout.metas, pend.layout.P,
                                        (1,) * len(pend.layout.mb_caps))
        with pytest.raises(ValueError, match="guard-bit"):
            pend.resolve_stats()


def test_payload_plan_fetch_and_unpack_equal_jax():
    """payload_plan's row indices and offsets, fetch_payload of a window
    with a non-zero block_base, and unpack_block are exactly the JAX
    package's; payload_plan's guard raises ValueError in both."""
    tiles = np.stack([_photo(7, 128, 128), _photo(8, 128, 128)])
    args = (128, 128, 3, 3, True, 8, 0.5, True)
    jp = j_pipeline.make_plan(*args)
    tp = t_pipeline.make_plan(*args)
    jres = j_frontend.dispatch_frontend(jp, tiles, mode="rows") \
        .resolve_stats(tile_off=1, n_tiles=1)
    tres = t_frontend.dispatch_frontend(tp, tiles, mode="rows",
                                        device="cpu") \
        .resolve_stats(tile_off=1, n_tiles=1)
    assert tres.block_base == jres.block_base > 0
    P = tres.layout.P
    rng = np.random.default_rng(9)
    floors = rng.integers(0, 4, tres.n_blocks).astype(np.int32)
    src, offs = t_frontend.payload_plan(tres.nbps, floors, P)
    jsrc, joffs = j_frontend.payload_plan(jres.nbps, floors, P)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(offs, joffs)
    payload = t_frontend.fetch_payload(tres, src)
    np.testing.assert_array_equal(payload,
                                  j_frontend.fetch_payload(jres, jsrc))
    for b in np.nonzero(tres.nbps > floors)[0][::7]:
        m = tres.layout.metas[b]
        got = t_frontend.unpack_block(payload, int(offs[b]),
                                      int(tres.nbps[b]), int(floors[b]),
                                      m.h, m.w)
        ref = j_frontend.unpack_block(payload, int(offs[b]),
                                      int(tres.nbps[b]), int(floors[b]),
                                      m.h, m.w)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    bad = tres.nbps.copy()
    bad[0] = P + 1
    for mod in (t_frontend, j_frontend):
        with pytest.raises(ValueError, match="capacity"):
            mod.payload_plan(bad, floors, P)


def test_fetch_in_pieces_equals_one_gather(monkeypatch):
    """The gather in GATHER_CHUNK-row pieces (here 128 rows, so the last
    piece is partial) gives the rows one index would."""
    monkeypatch.setattr(t_frontend, "GATHER_CHUNK", 128)
    rows = torch.as_tensor(np.random.default_rng(10).integers(
        0, 256, (300, 512), dtype=np.uint8))
    src = np.random.default_rng(11).integers(0, 300, 1000)
    np.testing.assert_array_equal(t_frontend.gather_rows(rows, src, 512),
                                  rows.numpy()[src])
    assert t_frontend.gather_rows(rows, src[:0], 512).shape == (0, 512)


# --- the host block coder --------------------------------------------------

def _same_blocks(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.data, g.n_bitplanes) == (r.data, r.n_bitplanes)
        assert [(p.pass_type, p.bitplane, p.cum_length, p.dist_reduction)
                for p in g.passes] == \
            [(p.pass_type, p.bitplane, p.cum_length, p.dist_reduction)
             for p in r.passes]


@pytest.mark.parametrize("lossless", [True, False])
def test_encode_packed_equals_jax_and_python(lossless):
    """t1_batch.encode_packed over a real packed payload (floors 0-3,
    dead blocks included): bytes, pass types and planes, truncation
    lengths and distortions identical to the JAX package's native
    library and to the port's pure-Python t1.encode_block over
    frontend.unpack_block."""
    tiles = np.stack([_photo(12, 128, 128)])
    args = (128, 128, 3, 3, lossless, 8, 0.5, True)
    tp = t_pipeline.make_plan(*args)
    tres = t_frontend.dispatch_frontend(tp, tiles, mode="rows",
                                        device="cpu").resolve_stats()
    floors = np.random.default_rng(13).integers(
        0, 4, tres.n_blocks).astype(np.int32)
    floors[::5] = tres.nbps[::5]          # dead blocks: no rows, no passes
    src, offs = t_frontend.payload_plan(tres.nbps, floors, tres.layout.P)
    payload = t_frontend.fetch_payload(tres, src)
    metas = tres.layout.metas
    hs = np.asarray([m.h for m in metas], np.int32)
    ws = np.asarray([m.w for m in metas], np.int32)
    bands = [tp.slots[m.slot_i].name for m in metas]
    got = t_t1_batch.encode_packed(payload, offs, tres.nbps, floors, hs,
                                   ws, bands)
    _same_blocks(got, j_t1_batch.encode_packed(payload, offs, tres.nbps,
                                               floors, hs, ws, bands))
    assert any(not b.passes for b in got) and any(b.passes for b in got)
    ref = []
    for i in range(len(metas)):
        if tres.nbps[i] <= floors[i]:
            ref.append(t_t1.CodedBlock(b"", 0))
            continue
        mags, negs = t_frontend.unpack_block(
            payload, int(offs[i]), int(tres.nbps[i]), int(floors[i]),
            int(hs[i]), int(ws[i]))
        ref.append(t_t1.encode_block(mags, negs, bands[i],
                                     floor=int(floors[i])))
    _same_blocks(got, ref)


def test_encode_blocks_equals_jax_and_python():
    """t1_batch.encode_blocks over host-sliced specs — full and partial
    extents, every band class, with and without fractional bits, an
    all-zero block — is the JAX native library's and t1.encode_block's
    output exactly."""
    rng = np.random.default_rng(14)
    specs = []
    for i, (h, w) in enumerate([(64, 64), (17, 40), (1, 64), (64, 3),
                                (32, 32), (5, 5)]):
        mags = (rng.integers(0, 1 << (i + 3), (h, w)) *
                (rng.random((h, w)) < 0.6)).astype(np.uint32)
        signs = rng.random((h, w)) < 0.5
        fracs = (rng.integers(0, 128, (h, w)).astype(np.uint8)
                 if i % 2 else None)
        specs.append((mags, signs, ("LL", "HL", "LH", "HH")[i % 4],
                      fracs))
    specs.append((np.zeros((8, 8), np.uint32), np.zeros((8, 8), bool),
                  "HH", None))
    got = t_t1_batch.encode_blocks(specs)
    _same_blocks(got, j_t1_batch.encode_blocks(specs))
    _same_blocks(got, [t_t1.encode_block(m, s, b, f)
                       for m, s, b, f in specs])
    assert t_t1_batch.encode_blocks([]) == []


# --- encodes -----------------------------------------------------------------

ROWS = {"device_mq": False, "device_cxd": False}

LOSSLESS_CASES = {
    "rgb_whole": (lambda: _photo(20, 80, 96), {"levels": 3}),
    "gray_whole": (lambda: _photo(21, 72, 64, 1), {"levels": 4}),
    "rgb_tiled": (lambda: _photo(22, 96, 136),
                  {"levels": 2, "tile_size": 64}),
    "gray_tiled_kakadu": (lambda: _photo(23, 100, 70, 1),
                          {"levels": 3, "tile_size": 64, "n_layers": 3,
                           "progression": cs.PROG_RPCL, "use_sop": True,
                           "use_eph": True, "gen_plt": True,
                           "tparts_r": True,
                           "precincts": ((256, 256), (128, 128))}),
}


@pytest.mark.parametrize("case", sorted(LOSSLESS_CASES))
def test_rows_lossless_equals_jax(case):
    """encode_jp2 in mode "rows" (device_mq=False, device_cxd=False):
    lossless bytes identical to the JAX encode_jp2(device_mq=False)."""
    make, kw = LOSSLESS_CASES[case]
    img = make()
    ref = j_encoder.encode_jp2(img, 8, j_encoder.EncodeParams(
        lossless=True, device_mq=False, **kw))
    stats = {}
    got = t_encoder.encode_jp2(img, 8, t_encoder.EncodeParams(
        lossless=True, **ROWS, **kw), device="cpu", stats=stats)
    assert got == ref
    # The host coder counts no symbols: absent, not zero.
    assert stats["blocks"] > 0 and stats["bytes"] > 0
    assert "symbols" not in stats


def test_rows_lossy_equals_fused():
    """Lossy (9/7 + ICT, rate 3, the rate estimator's floors): the rows
    file equals the port's own fused file byte for byte."""
    img = _photo(24, 64, 64)
    params = t_encoder.EncodeParams.kakadu_recipe(False)
    params.levels, params.tile_size = 3, None
    params.device_mq = True
    fused = t_encoder.encode_jp2(img, 8, params, device="cpu")
    params.device_mq, params.device_cxd = False, False
    assert t_encoder.encode_jp2(img, 8, params, device="cpu") == fused


@pytest.mark.parametrize("shape,tile,levels", [
    ((192, 192, 3), 96, 2), ((456, 328), 200, 3)])
def test_straddling_grid_equals_jax(shape, tile, levels):
    """Tile grids whose sub-bands straddle the 64-grid (tile 96 at 2
    levels as in tests/test_codec_roundtrip.py; tile 200 at 3 levels
    with ragged edge tiles) code through the host-sliced path:
    lossless bytes identical to the JAX encoder's, whatever Tier-1 the
    params name."""
    img = _photo(25, shape[0], shape[1], 3 if len(shape) == 3 else 1)
    plan = t_pipeline.make_plan(tile, tile, 1, levels, True, 8)
    assert t_encoder._grid_aligned(plan, (tile, tile)) == "straddle"
    ref = j_encoder.encode_jp2(img, 8, j_encoder.EncodeParams(
        lossless=True, levels=levels, tile_size=tile))
    stats = {}
    got = t_encoder.encode_jp2(img, 8, t_encoder.EncodeParams(
        lossless=True, levels=levels, tile_size=tile), device="cpu",
        stats=stats)
    assert got == ref
    assert "symbols" not in stats and stats["blocks"] > 0


def test_mismatch_grid_and_mesh_still_raise():
    """A "mismatch" grid raises, with a mesh or without; a mesh of
    another device type than the encode's raises."""
    from bucketeer_tpu_torch.parallel import make_mesh

    img = _photo(26, 100, 100, 1)
    for mesh in (None, make_mesh(["cpu"] * 2)):
        with pytest.raises(NotImplementedError, match="Mallat"):
            t_encoder.encode_jp2(img, 8, t_encoder.EncodeParams(
                levels=2, tile_size=50, **ROWS), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="mesh of cuda"):
        t_encoder.encode_jp2(img, 8, mesh=make_mesh(["cuda:0"]),
                             device="cpu")


def test_rows_encode_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        t_encoder.encode_jp2(_photo(27, 32, 32, 1), 8,
                             t_encoder.EncodeParams(**ROWS),
                             device="cuda")


# --- the scheduler merges rows launches -------------------------------------

def _pair(sched, imgs, params):
    """Both encodes admitted before either dispatches (a barrier inside
    the slot), so the first front-end job waits in the window for the
    second. Returns (outputs, errors)."""
    from bucketeer_tpu_torch.codec import encoder

    gate = threading.Barrier(2)
    outs, errs = [None, None], [None, None]

    def request(i):
        def body():
            gate.wait(timeout=30)
            return encoder.encode_jp2(imgs[i], 8, params, device="cpu")
        try:
            outs[i] = sched.submit(body)
        except Exception as exc:
            errs[i] = exc

    threads = [threading.Thread(target=request, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return outs, errs


def test_concurrent_rows_encodes_merge_one_launch():
    """Two concurrent rows encodes through EncodeScheduler(device="cpu")
    share one front-end launch (occupancy 2); each output equals its
    solo run."""
    imgs = [_photo(30, 48, 40), _photo(31, 48, 40)]
    params = t_encoder.EncodeParams(lossless=True, levels=3, **ROWS)
    solo = [t_encoder.encode_jp2(im, 8, params, device="cpu")
            for im in imgs]
    sink = Metrics()
    sched = EncodeScheduler(device="cpu", devices=1, window_s=10.0)
    sched.set_metrics_sink(sink)
    try:
        outs, errs = _pair(sched, imgs, params)
    finally:
        sched.close()
    assert errs == [None, None]
    assert outs == solo
    rep = sink.report()
    assert rep["counters"]["encode.device_launches"] == 1
    assert rep["counters"]["encode.batched_tiles"] == 2
    assert rep["values"]["encode.batch_occupancy"]["max"] == 2


def test_failed_merged_launch_raises_in_both(monkeypatch):
    """A merged launch that fails delivers its error to both waiting
    requests; none hangs."""
    from bucketeer_tpu_torch.codec import frontend

    calls = []

    def failing(plan, tiles, mode="mq", device=None):
        calls.append((len(tiles), mode))
        raise ValueError("merged launch failed")

    monkeypatch.setattr(frontend, "dispatch_frontend", failing)
    imgs = [_photo(32, 32, 32, 1), _photo(33, 32, 32, 1)]
    sched = EncodeScheduler(device="cpu", devices=1, window_s=10.0)
    try:
        outs, errs = _pair(sched, imgs, t_encoder.EncodeParams(
            lossless=True, levels=2, **ROWS))
    finally:
        sched.close()
    assert calls == [(2, "rows")]
    assert outs == [None, None]
    assert all(isinstance(e, ValueError) and "merged launch failed"
               in str(e) for e in errs)


# --- the service's Tier-1 keys ----------------------------------------------

async def test_properties_file_selects_host_tier1(tmp_path, monkeypatch,
                                                  aiohttp_client):
    """A properties file with bucketeer.tpu.device.mq=false: the port's
    Engine(device="cpu") codes a single-image request on the host Tier-1
    (encode_packed runs), and the stored object equals the direct rows
    encode."""
    from PIL import Image

    from bucketeer_tpu_torch import config as t_cfg
    from bucketeer_tpu_torch import features as t_features
    from bucketeer_tpu_torch.converters import Conversion, CudaConverter
    from bucketeer_tpu_torch.engine import Engine, FakeS3Client
    from bucketeer_tpu_torch.engine import RecordingSlackClient
    from bucketeer_tpu_torch.server.app import build_app

    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(work))
    props = tmp_path / "bucketeer.properties"
    props.write_text(f"{t_cfg.DEVICE_MQ}=false\n")
    config = t_cfg.Config.load(str(props), overrides={
        t_cfg.IIIF_URL: "http://iiif.test/iiif",
        t_cfg.SLACK_CHANNEL_ID: "chan",
        t_cfg.FILESYSTEM_CSV_MOUNT: str(tmp_path / "csv-mount"),
        t_cfg.FILESYSTEM_IMAGE_MOUNT: str(tmp_path),
        t_cfg.S3_REQUEUE_DELAY: 0.01})
    packed = []
    real = t_t1_batch.encode_packed
    monkeypatch.setattr(t_t1_batch, "encode_packed",
                        lambda *a, **k: packed.append(1) or real(*a, **k))
    img = _photo(34, 40, 48)
    src = tmp_path / "src.tif"
    Image.fromarray(img).save(src)
    # A converter of its own: the keys must not reach the process-wide
    # CPU converter other tests share.
    engine = Engine(config, flags=t_features.FeatureFlagChecker(static={}),
                    converter=CudaConverter(device="cpu"),
                    s3_client=FakeS3Client(str(tmp_path / "s3")),
                    slack_client=RecordingSlackClient(), device="cpu")
    assert engine.converter.device_mq is False
    client = await aiohttp_client(build_app(engine))
    resp = await client.get(f"/images/ark%3A%2F9%2Frows/{src}")
    assert resp.status == 201, await resp.text()
    for _ in range(1500):
        if engine.s3_client.metadata and not engine.image_worker.background:
            break
        await __import__("asyncio").sleep(0.02)
    (key,) = engine.s3_client.metadata
    with open(f"{engine.s3_client.root}/{key}", "rb") as fh:
        stored = fh.read()
    params = engine.converter.encode_params(40, 48, 8, Conversion.LOSSLESS)
    assert (params.device_mq, params.device_cxd) == (False, None)
    assert packed
    assert stored == t_encoder.encode_jp2(img, 8, params, jpx=True,
                                          device="cpu")
    await client.close()


def test_encode_packed_refuses_a_short_payload():
    """A payload with fewer rows than a live block's offset and planes
    ask for is refused before the coder reads past it."""
    nbps = np.array([3, 0], np.int32)
    floors = np.zeros(2, np.int32)
    offs = np.array([0, 4, 4], np.int64)
    args = (nbps, floors, np.full(2, 64, np.int32),
            np.full(2, 64, np.int32), ["LL", "HH"])
    with pytest.raises(ValueError, match="packed layout"):
        t_t1_batch.encode_packed(np.zeros((3, 512), np.uint8), offs, *args)
    assert len(t_t1_batch.encode_packed(np.zeros((4, 512), np.uint8),
                                        offs, *args)) == 2
