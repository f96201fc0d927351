"""The port's batch data plane against the JAX package's (tests/
test_batches.py), on the CPU: recipe validation (the same typed
InvalidParam, message for message), batch assembly on the same
codestreams (made by the JAX encoder, as JAX's fixtures are) equal to
JAX's assembly — bands, ids, manifest, deltas, layout, meta — with the
port's visible devices set to 8 CPU entries as conftest.py sets JAX's,
the merged dequantizer and the BandSlice gather through a CPU scheduler,
the batch-fatal errors, and the BTB1 store byte for byte.

The store's items are 16 px, one level, low amplitude: a CPU batch
codes its bands with fused_t1's plain version, which takes seconds per
coded bit-plane here.
"""
import dataclasses
import struct
import threading

import numpy as np
import pytest
import torch

from bucketeer_tpu.batches import BatchRecipe as JRecipe
from bucketeer_tpu.batches import assemble_batch as j_assemble
from bucketeer_tpu.batches import encode_batch as j_encode_batch
from bucketeer_tpu.batches import parse_recipe as j_parse
from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu.codec.decode.errors import DecodeError as JDecodeError
from bucketeer_tpu.codec.decode.errors import InvalidParam as JInvalid
from bucketeer_tpu.codec.encoder import EncodeParams as JParams
from bucketeer_tpu.engine.scheduler import EncodeScheduler as JScheduler
from bucketeer_tpu_torch.batches import (BatchRecipe, assemble_batch,
                                         decode_batch, encode_batch,
                                         parse_recipe, truncate_batch)
from bucketeer_tpu_torch.batches.store import MAGIC, batch_stats
from bucketeer_tpu_torch.codec.decode.errors import DecodeError, InvalidParam
from bucketeer_tpu_torch.engine.scheduler import (DeadlineExceeded,
                                                  EncodeScheduler,
                                                  SchedulerClosed)
from bucketeer_tpu_torch.parallel import mesh as t_pmesh
from bucketeer_tpu_torch.server.metrics import Metrics
from bucketeer_tpu_torch.tensor import coeffs as t_coeffs
from bucketeer_tpu_torch.tensor import decode_to_coefficients


def _encode(size=32, lossless=True, levels=2, seed=7, amp=None):
    rng = np.random.default_rng(seed)
    if amp is None:
        img = rng.integers(0, 256, size=(size, size, 3))
    else:
        img = 128 + rng.integers(-amp, amp + 1, size=(size, size, 3))
    return j_encoder.encode_jp2(
        img.astype(np.uint8), 8,
        JParams(lossless=lossless, levels=levels, tile_size=size,
                gen_plt=True), jpx=True)


@pytest.fixture(scope="module")
def blobs8():
    """Eight compatible reversible 32px codestreams, keyed img0..img7."""
    return {f"img{i}": _encode(seed=100 + i) for i in range(8)}


@pytest.fixture(scope="module")
def lossy4():
    """Four compatible irreversible (9/7, float32) codestreams."""
    return {f"lossy{i}": _encode(lossless=False, seed=200 + i)
            for i in range(4)}


@pytest.fixture(autouse=True)
def eight_entries(monkeypatch):
    """The port's batch mesh spans 8 CPU entries, as JAX's spans the 8
    CPU devices conftest.py forces."""
    monkeypatch.setattr(t_pmesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * 8)


def _assemble(recipe, **kw):
    return assemble_batch(recipe, device="cpu", **kw)


def _jrecipe(recipe):
    return JRecipe(**dataclasses.asdict(recipe))


def _oracle(blobs, ids, **kwargs):
    """Stacked per-image decode_to_coefficients — the ground truth the
    batch plane must match bit-for-bit."""
    hosts = [decode_to_coefficients(blobs[i], device="cpu",
                                    **kwargs).to_host() for i in ids]
    return {key: np.stack([h[key] for h in hosts]) for key in hosts[0]}


def _assert_equal_hosts(got, expected):
    assert set(got) == set(expected)
    for key in expected:
        assert got[key].dtype == expected[key].dtype, key
        np.testing.assert_array_equal(got[key], expected[key])


def _assert_same_as_jax(result, jresult):
    """Every field of the port's BatchResult equals JAX's."""
    _assert_equal_hosts(result.to_host(), jresult.to_host())
    assert result.ids == jresult.ids
    assert result.manifest == jresult.manifest
    assert result.deltas == jresult.deltas
    assert result.layout == jresult.layout
    assert result.meta == jresult.meta
    assert result.nbytes == jresult.nbytes


# --- recipe validation -------------------------------------------------

def test_recipe_parse_roundtrip():
    doc = {"ids": ["a", "b"], "region": [8, 8, 16, 16], "reduce": 1,
           "layers": 2, "dtype": "int32", "layout": "sharded",
           "store": True, "planes": 4, "deadline_s": 30}
    r = parse_recipe(doc)
    assert r == BatchRecipe(ids=("a", "b"), region=(8, 8, 16, 16),
                            reduce=1, layers=2, dtype="int32",
                            layout="sharded", store=True, planes=4,
                            deadline_s=30.0)
    assert dataclasses.astuple(r) == dataclasses.astuple(j_parse(doc))
    assert parse_recipe({"ids": ["x"]}).layout == "auto"


def _outcome(parse, invalid, doc):
    try:
        return ("ok", dataclasses.astuple(parse(doc)))
    except invalid as exc:
        return ("invalid", str(exc))


@pytest.mark.parametrize("doc", [
    None, [], "ids", 42,
    {},                                        # no ids
    {"ids": []},                               # empty ids
    {"ids": "img0"},                           # not a list
    {"ids": [1, 2]},                           # non-string ids
    {"ids": ["ok", "bad id"]},                 # id fails the charset
    {"ids": ["a" * 300]},                      # id too long
    {"ids": [f"i{k}" for k in range(200)]},    # over MAX_ITEMS
    {"ids": ["a"], "bogus": 1},                # unknown key
    {"ids": ["a"], "region": [1, 2, 3]},       # 3-tuple region
    {"ids": ["a"], "region": [0, 0, 0, 5]},    # zero-size region
    {"ids": ["a"], "region": [-1, 0, 4, 4]},   # negative origin
    {"ids": ["a"], "region": [0, 0, True, 4]},  # bool is not an int
    {"ids": ["a"], "region": "0,0,4,4"},       # string region
    {"ids": ["a"], "reduce": -1},
    {"ids": ["a"], "reduce": 99},
    {"ids": ["a"], "reduce": 1.5},
    {"ids": ["a"], "layers": 0},
    {"ids": ["a"], "dtype": "int8"},
    {"ids": ["a"], "layout": "mesh"},
    {"ids": ["a"], "store": "yes"},
    {"ids": ["a"], "planes": 4},               # planes without store
    {"ids": ["a"], "store": True, "planes": 0},
    {"ids": ["a"], "deadline_s": 0},
    {"ids": ["a"], "deadline_s": -5},
    {"ids": ["a"], "deadline_s": 1e9},
    {"ids": ["a"], "deadline_s": "soon"},
])
def test_recipe_fuzz_typed_invalid(doc):
    """The same typed InvalidParam, with the same message, in both
    packages."""
    with pytest.raises(InvalidParam) as err:
        parse_recipe(doc)
    assert _outcome(j_parse, JInvalid, doc) == ("invalid", str(err.value))


def test_recipe_fuzz_random_mutations():
    """Seeded garbage over the recipe keyspace: every outcome is a
    parsed recipe or a typed InvalidParam, the same as JAX's."""
    rng = np.random.default_rng(17)
    pool = [None, True, False, -1, 0, 1, 3.7, "x", "", [], {}, ["a"],
            [0], {"k": 1}, float("nan"), "int32", "sharded", [1, 2, 3, 4]]
    keys = ["ids", "region", "reduce", "layers", "dtype", "layout",
            "store", "planes", "deadline_s", "junk"]
    kinds = set()
    for _ in range(300):
        doc = {keys[k]: pool[v] for k, v in zip(
            rng.integers(0, len(keys), size=rng.integers(0, 6)),
            rng.integers(0, len(pool), size=6))}
        got = _outcome(parse_recipe, InvalidParam, doc)
        assert got == _outcome(j_parse, JInvalid, doc), doc
        kinds.add(got[0])
    assert kinds == {"ok", "invalid"}


# --- assembly against JAX's --------------------------------------------

def test_assemble_reversible_sharded_matches_jax(blobs8):
    """Eight reversible images through an admitted batchread on a CPU
    scheduler: int32 bands equal to JAX's assembly and to per-image
    decode+stack, split one item per entry over the 8-entry mesh; the
    per-image dequants merge into one launch at the fan-out width, and
    assembly gathers the rows of its shared output (no per-item
    materialization)."""
    ids = tuple(sorted(blobs8))
    sched = EncodeScheduler(device="cpu", queue_depth=16,
                            max_concurrent=8, devices=1, window_s=2.0)
    sink = Metrics()
    sched.set_metrics_sink(sink)
    widths, materialized = [], []
    dispatch = sched.dispatch_dequant

    def spy(*a, **kw):
        widths.append(kw["_expected"])
        return dispatch(*a, **kw)

    sched.dispatch_dequant = spy
    orig = t_coeffs.BandSlice.materialize

    def counted(self):
        materialized.append(self.index)
        return orig(self)

    t_coeffs.BandSlice.materialize = counted
    try:
        result = sched.submit_batchread(assemble_batch, BatchRecipe(ids),
                                        data_for=blobs8.get, device="cpu")
    finally:
        t_coeffs.BandSlice.materialize = orig
        sched.close()
    jsched = JScheduler(queue_depth=16, max_concurrent=8, devices=1,
                        window_s=0.3)
    try:
        jresult = jsched.submit_batchread(j_assemble, JRecipe(ids),
                                          data_for=blobs8.get)
    finally:
        jsched.close()

    assert result.layout == "sharded"
    _assert_same_as_jax(result, jresult)
    _assert_equal_hosts(result.to_host(), _oracle(blobs8, ids))
    for parts in result.bands.values():
        assert len(parts) == 8 and all(p.shape[0] == 1 for p in parts)
        assert all(p.dtype == torch.int32 for p in parts)
    assert result.meta["n_devices"] == 8
    assert widths == [8] * 8
    report = sink.report()
    counters = report["counters"]
    assert counters["batchread.merged_images"] == 8
    assert counters["batchread.device_launches"] == 1
    assert report["values"]["batchread.batch_occupancy"]["max"] == 8
    assert materialized == []


def test_assemble_irreversible_float32_replicated(lossy4):
    """Four irreversible images: float32 bands equal to JAX's; under
    layout=auto a 4-item batch does not divide the 8-entry mesh, so
    every entry holds the full batch."""
    ids = tuple(sorted(lossy4))
    recipe = BatchRecipe(ids=ids, dtype="float32")
    sched = EncodeScheduler(device="cpu", queue_depth=16,
                            max_concurrent=8, devices=1, window_s=0.3)
    try:
        result = sched.submit_batchread(assemble_batch, recipe,
                                        data_for=lossy4.get, device="cpu")
    finally:
        sched.close()
    jresult = j_assemble(_jrecipe(recipe), data_for=lossy4.get)
    assert result.layout == "replicated"
    _assert_same_as_jax(result, jresult)
    for key, parts in result.bands.items():
        assert len(parts) == 8
        assert all(torch.equal(p, parts[0]) for p in parts)
        assert parts[0].dtype == torch.float32


def test_assemble_region_reduce_layers_standalone(blobs8):
    """region/reduce/layers apply uniformly to every item; a standalone
    call (inline dequant) equals JAX's and the per-image oracle."""
    ids = ("img0", "img3", "img5")
    kwargs = dict(region=(8, 8, 16, 16), reduce=1, layers=1)
    recipe = BatchRecipe(ids=ids, **kwargs)
    result = _assemble(recipe, data_for=blobs8.get)
    assert result.layout == "replicated"     # 3 items on 8 entries
    assert result.meta["reduce"] == 1
    _assert_same_as_jax(result, j_assemble(_jrecipe(recipe),
                                           data_for=blobs8.get))
    _assert_equal_hosts(result.to_host(), _oracle(blobs8, ids, **kwargs))


def test_assemble_request_shaped_errors(blobs8, lossy4):
    both = dict(blobs8)
    both.update(lossy4)
    both["tiny"] = _encode(size=16, seed=5)
    cases = [
        ("unknown image ids", BatchRecipe(ids=("img0", "nope", "gone"))),
        ("mixed geometry", BatchRecipe(ids=("img0", "tiny"))),
        ("mixed geometry", BatchRecipe(ids=("img0", "lossy0"))),
        ("beyond the", BatchRecipe(ids=("img0", "img1"), reduce=5)),
        ("dtype=float32", BatchRecipe(ids=("img0",), dtype="float32")),
        ("dtype=int32", BatchRecipe(ids=("lossy0",), dtype="int32")),
        ("outside the", BatchRecipe(ids=("img0",), region=(64, 0, 8, 8))),
        ("does not divide", BatchRecipe(ids=("img0", "img1", "img2"),
                                        layout="sharded")),
    ]
    for match, recipe in cases:
        with pytest.raises(InvalidParam, match=match) as err:
            _assemble(recipe, data_for=both.get)
        with pytest.raises(JInvalid) as jerr:
            j_assemble(_jrecipe(recipe), data_for=both.get)
        assert str(err.value) == str(jerr.value)


def test_assemble_partial_failure_manifest(blobs8):
    """A corrupt item fails alone, with JAX's typed manifest entry; the
    surviving rows stay bit-exact and in recipe order."""
    ids = ("img0", "img1", "img2", "img3")
    blobs = {i: blobs8[i] for i in ids}
    blobs["img2"] = blobs["img2"][:len(blobs["img2"]) // 2]
    recipe = BatchRecipe(ids=ids)
    result = _assemble(recipe, data_for=blobs.get)
    jresult = j_assemble(_jrecipe(recipe), data_for=blobs.get)
    assert [e["id"] for e in result.manifest] == list(ids)
    assert [e["ok"] for e in result.manifest] == [True, True, False, True]
    bad = result.manifest[2]
    assert bad["error"] and bad["message"]
    assert result.ids == ("img0", "img1", "img3")
    _assert_same_as_jax(result, jresult)
    _assert_equal_hosts(result.to_host(),
                        _oracle(blobs8, ["img0", "img1", "img3"]))


def test_assemble_all_items_failed(blobs8):
    blobs = {"a": blobs8["img0"][:40], "b": blobs8["img1"][:40]}
    with pytest.raises(DecodeError):
        _assemble(BatchRecipe(ids=("a", "b")), data_for=blobs.get)
    with pytest.raises(JDecodeError):
        j_assemble(JRecipe(ids=("a", "b")), data_for=blobs.get)


# --- batch-fatal errors through the scheduler ---------------------------

def test_deadline_mid_fanout_is_batch_fatal(blobs8):
    """The deadline expires while the items are fetched: every item's
    Tier-1 poll raises, the batch raises DeadlineExceeded, and no item
    job is left on the device queue."""
    sched = EncodeScheduler(device="cpu", devices=1, window_s=0.3)

    def slow(image_id):
        threading.Event().wait(0.3)
        return blobs8[image_id]

    try:
        with pytest.raises(DeadlineExceeded):
            sched.submit_batchread(assemble_batch,
                                   BatchRecipe(ids=("img0", "img1")),
                                   data_for=slow, device="cpu",
                                   deadline_s=0.2)
        assert not sched._djobs
        assert sched.stats()["admitted"] == 0
    finally:
        sched.close()


def test_close_mid_fanout_is_batch_fatal(blobs8):
    """close() while the batch is admitted: the items' dequant launches
    are refused typed, the batch raises SchedulerClosed (never hangs)
    and no item job is left queued."""
    sched = EncodeScheduler(device="cpu", devices=1, window_s=0.3)
    entered, release = threading.Event(), threading.Event()

    def gated(image_id):
        entered.set()
        assert release.wait(30)
        return blobs8[image_id]

    out = {}

    def run():
        try:
            sched.submit_batchread(assemble_batch,
                                   BatchRecipe(ids=("img0", "img1")),
                                   data_for=gated, device="cpu")
        except SchedulerClosed as exc:
            out["error"] = exc

    t = threading.Thread(target=run)
    t.start()
    assert entered.wait(30)
    sched.close()
    release.set()
    t.join(timeout=30)
    assert not t.is_alive(), "batch read hung after close()"
    assert isinstance(out.get("error"), SchedulerClosed)
    assert not sched._djobs


def test_dequant_launches_merge_to_expected_width():
    """Three concurrent compatible dequant dispatches with _expected=3
    merge into ONE pool launch; each caller still gets its own slice
    back (stub pool, launch identity observable)."""
    launches = []

    def stub(plan, arrays, mode="rows"):
        assert mode == "dequant"
        launches.append(len(arrays))
        return "launch-%d" % len(launches)

    sched = EncodeScheduler(device="cpu", queue_depth=8, max_concurrent=4,
                            devices=1, window_s=2.0)
    sched.launch_fn = stub
    try:
        arrays = [np.arange(6, dtype=np.int32).reshape(2, 3)]
        outs = [None] * 3
        barrier = threading.Barrier(3)

        def client(i):
            barrier.wait()
            outs[i] = sched.dispatch_dequant(True, (0.5,), arrays,
                                             _expected=3)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "dequant dispatch hung"
    finally:
        sched.close()
    assert launches == [3]
    assert outs == [("launch-1", 3)] * 3


def test_band_slice_views():
    parent = torch.arange(24, dtype=torch.int32).reshape(4, 2, 3)
    v = t_coeffs.BandSlice(parent, 2)
    assert v.shape == (2, 3)
    assert v.dtype == torch.int32
    assert torch.equal(v.materialize(), parent[2])
    np.testing.assert_array_equal(np.asarray(v), parent[2].numpy())
    assert np.asarray(v, dtype=np.float64).dtype == np.float64


# --- BTB1 stored container --------------------------------------------

@pytest.fixture(scope="module")
def stored():
    """Two 16 px, one-level, low-amplitude reversible items, their CPU
    batch, its BTB1 blob (fused_t1's plain version codes the bands) and
    JAX's assembly of the same codestreams."""
    blobs = {f"s{i}": _encode(size=16, levels=1, seed=40 + i, amp=1)
             for i in range(2)}
    recipe = BatchRecipe(ids=tuple(sorted(blobs)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_pmesh, "visible_devices",
                   lambda device="cuda": [torch.device("cpu")] * 8)
        result = _assemble(recipe, data_for=blobs.get)
    jresult = j_assemble(_jrecipe(recipe), data_for=blobs.get)
    return result, encode_batch(result), jresult


def test_btb1_bytes_equal_jax(stored):
    result, blob, jresult = stored
    assert result.device == "cpu"
    assert blob == j_encode_batch(jresult)
    assert encode_batch(result, planes=1) == j_encode_batch(jresult,
                                                            planes=1)


def test_btb1_roundtrip_exact(stored):
    result, blob, _ = stored
    assert blob[:4] == MAGIC
    header, bands = decode_batch(blob)
    assert header["ids"] == list(result.ids)
    assert header["layout"] == result.layout
    assert [e["ok"] for e in header["manifest"]] == [True, True]
    _assert_equal_hosts(bands, result.to_host())


def test_btb1_progressive_truncation(stored):
    result, blob, _ = stored
    cut = truncate_batch(blob, planes=30)
    assert len(cut) < len(blob)
    header, bands = decode_batch(cut)
    _, direct = decode_batch(blob, planes=30)
    host = result.to_host()
    for key in host:
        assert bands[key].shape == host[key].shape
        np.testing.assert_array_equal(bands[key], direct[key])
    stats = batch_stats(cut)
    assert stats["ids"] == list(result.ids)
    assert stats["n_bands"] == len(host)
    assert stats["coded_bytes"] == len(cut)


@pytest.mark.parametrize("mangle", [
    lambda b: b[:3],                                   # shorter than magic
    lambda b: b"XXXX" + b[4:],                         # flipped magic
    lambda b: b[:4] + struct.pack(">BI", 9, 1) + b[9:],  # bad version
    lambda b: b[:5] + struct.pack(">I", 1 << 30) + b[9:],  # header overrun
    lambda b: b[:12] + b"\x00" + b[13:],               # mangled JSON
    lambda b: b[:len(b) // 2],                         # tail-truncated
    lambda b: b[:9],                                   # header missing
])
def test_btb1_corruption_typed(stored, mangle):
    _, blob, _ = stored
    with pytest.raises(DecodeError):
        decode_batch(mangle(blob))
    with pytest.raises(DecodeError):
        truncate_batch(mangle(blob), planes=1)
