"""converters/reader.py CudaReader (on the CPU) and its two cache tiers:
hit/miss counters, byte-budget eviction, file-identity invalidation,
read-only entries, clamp-normalized region keys, the single-flight
stream-index tier; reads through a scheduler (admitted misses at read
priority); and what the port cannot serve (a card without CUDA)."""
import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import encoder
from bucketeer_tpu.codec.encoder import EncodeParams
from bucketeer_tpu.converters.reader import TpuReader
from bucketeer_tpu.server.metrics import Metrics
from bucketeer_tpu_torch.codec.decode import DecodeError, t1_dec
from bucketeer_tpu_torch.converters import ConverterError, CudaReader
from bucketeer_tpu_torch.converters import reader as reader_mod
from bucketeer_tpu_torch.converters.reader import _DecodeCache, _IndexCache
from bucketeer_tpu_torch.tensor import decode_to_coefficients


def _reader(**kw):
    return CudaReader(device="cpu", **kw)


def _write_jp2(tmp_path, name, seed=3, size=48):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (size, size), dtype=np.uint8)
    data = encoder.encode_jp2(img, 8, EncodeParams(lossless=True,
                                                   levels=3))
    path = tmp_path / name
    path.write_bytes(data)
    return str(path), img


def _write_region_jp2(tmp_path, name, size=64, seed=9):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    params = dataclasses.replace(
        EncodeParams.kakadu_recipe(lossless=True), tile_size=size,
        levels=3)
    path = tmp_path / name
    path.write_bytes(encoder.encode_jp2(img, 8, params))
    return str(path), img


def test_cache_hit_serves_identical_pixels(tmp_path):
    path, img = _write_jp2(tmp_path, "a.jp2")
    sink = Metrics()
    reader = _reader(cache_mb=4, metrics=sink)
    first = reader.read(path)
    second = reader.read(path)
    assert np.array_equal(first, img) and second is first
    counters = sink.report()["counters"]
    assert counters["decode.cache_misses"] == 1
    assert counters["decode.cache_hits"] == 1


def test_reads_equal_the_jax_reader(tmp_path):
    path, _ = _write_region_jp2(tmp_path, "same.jp2")
    ours, theirs = _reader(cache_mb=4), TpuReader(cache_mb=4)
    for kw in ({}, {"reduce": 2}, {"region": (5, 9, 40, 50)},
               {"region": (30, 30, 99, 99), "reduce": 1, "layers": 3}):
        np.testing.assert_array_equal(ours.read(path, **kw),
                                      theirs.read(path, **kw))
    assert ours.probe(path) == theirs.probe(path)
    assert ours.dims(path) == theirs.dims(path) == (64, 64)


def test_cache_keyed_by_reduce_and_layers(tmp_path):
    path, _ = _write_jp2(tmp_path, "b.jp2")
    sink = Metrics()
    reader = _reader(cache_mb=4, metrics=sink)
    full = reader.read(path)
    thumb = reader.read(path, reduce=1)
    assert thumb.shape[0] < full.shape[0]
    assert np.array_equal(reader.read(path, reduce=1), thumb)
    reader.read(path, layers=1)
    counters = sink.report()["counters"]
    assert counters["decode.cache_misses"] == 3     # distinct keys
    assert counters["decode.cache_hits"] == 1


def test_rewritten_derivative_is_not_served_stale(tmp_path):
    path, img_a = _write_jp2(tmp_path, "c.jp2", seed=3)
    reader = _reader(cache_mb=4)
    assert np.array_equal(reader.read(path), img_a)
    path_b, img_b = _write_jp2(tmp_path, "other.jp2", seed=4)
    os.replace(path_b, path)          # re-converted derivative
    os.utime(path, ns=(1, 1))         # visible even on coarse mtimes
    assert np.array_equal(reader.read(path), img_b)


def test_cached_arrays_are_read_only(tmp_path):
    path, _ = _write_jp2(tmp_path, "d.jp2")
    reader = _reader(cache_mb=4)
    reader.read(path)
    cached = reader.read(path)
    with pytest.raises(ValueError):
        cached[0, 0] = 0


def _same_bands(a, b) -> bool:
    return list(a.bands) == list(b.bands) and all(
        torch.equal(a.bands[k], b.bands[k]) for k in a.bands)


@pytest.mark.parametrize("changed", ["hit", "miss"])
def test_coefficient_read_changed_in_place_leaves_later_reads(tmp_path,
                                                             changed):
    """Changing a coefficient read's bands in place, the miss's own
    result or a cache hit's, changes no later read: the next hit still
    equals a fresh decode_to_coefficients (ROADMAP C.6)."""
    path, _ = _write_jp2(tmp_path, "k.jp2")
    with open(path, "rb") as fh:
        fresh = decode_to_coefficients(fh.read(), device="cpu")
    sink = Metrics()
    reader = _reader(cache_mb=4, metrics=sink)
    mine = reader.read_coefficients(path)
    if changed == "hit":
        mine = reader.read_coefficients(path)
    for band in mine.bands.values():
        band.add_(1000)
    later = reader.read_coefficients(path)
    assert sink.report()["counters"]["decode.cache_misses"] == 1
    assert _same_bands(later, fresh) and not _same_bands(mine, fresh)


def test_coefficient_reads_share_no_storage(tmp_path):
    """A miss and two hits of one key are three sets whose bands share
    no storage with each other."""
    path, _ = _write_jp2(tmp_path, "s.jp2")
    reader = _reader(cache_mb=4)
    sets = [reader.read_coefficients(path) for _ in range(3)]
    assert len({id(cs) for cs in sets}) == 3
    for key in sets[0].bands:
        ptrs = {cs.bands[key].untyped_storage().data_ptr() for cs in sets}
        assert len(ptrs) == 3, key
    assert _same_bands(sets[1], sets[0]) and _same_bands(sets[2], sets[0])


def test_cache_disabled_with_zero_budget(tmp_path):
    path, _ = _write_jp2(tmp_path, "e.jp2")
    sink = Metrics()
    reader = _reader(cache_mb=0, metrics=sink)
    reader.read(path)
    reader.read(path)
    assert reader.cache is None
    assert "decode.cache_hits" not in sink.report().get("counters", {})


def test_env_budgets(tmp_path, monkeypatch):
    monkeypatch.setenv("BUCKETEER_DECODE_CACHE_MB", "3")
    monkeypatch.setenv("BUCKETEER_INDEX_CACHE_ENTRIES", "5")
    reader = _reader()
    assert reader.cache.max_bytes == 3 << 20
    assert reader.index_cache.max_entries == 5
    monkeypatch.setenv("BUCKETEER_DECODE_CACHE_MB", "0")
    monkeypatch.setenv("BUCKETEER_INDEX_CACHE_ENTRIES", "junk")
    reader = _reader()
    assert reader.cache is None
    assert reader.index_cache.max_entries == reader_mod.DEFAULT_INDEX_ENTRIES


def test_lru_eviction_by_byte_budget():
    cache = _DecodeCache(max_bytes=100)
    for key in ("a", "b"):
        cache.put(key, np.zeros(40, np.uint8))
    assert cache.get("a") is not None     # refresh a: b becomes LRU
    cache.put("c", np.zeros(40, np.uint8))
    assert cache.evictions == 1
    assert cache.get("b") is None
    assert cache.get("a") is not None and cache.get("c") is not None
    assert cache.nbytes <= 100


def test_oversized_entry_is_not_cached():
    cache = _DecodeCache(max_bytes=10)
    cache.put("big", np.zeros(100, np.uint8))
    assert len(cache) == 0 and cache.evictions == 0


def test_eviction_counter_reaches_metrics(tmp_path):
    path_a, _ = _write_jp2(tmp_path, "f.jp2", seed=5)
    path_b, _ = _write_jp2(tmp_path, "g.jp2", seed=6)
    sink = Metrics()
    reader = _reader(cache_mb=1, metrics=sink)
    reader.cache.max_bytes = 3000         # below two decoded images
    reader.read(path_a)
    reader.read(path_b)
    assert sink.report()["counters"]["decode.cache_evictions"] >= 1


# --- region keys and the stream-index tier ------------------------------

def test_region_reads_have_their_own_tile_keys(tmp_path):
    path, img = _write_region_jp2(tmp_path, "r.jp2")
    sink = Metrics()
    reader = _reader(cache_mb=4, metrics=sink)
    a = reader.read(path, region=(0, 0, 16, 16))
    b = reader.read(path, region=(16, 0, 16, 16))
    assert np.array_equal(a, img[0:16, 0:16])
    assert np.array_equal(b, img[0:16, 16:32])
    assert reader.read(path, region=(0, 0, 16, 16)) is a
    counters = sink.report()["counters"]
    assert counters["decode.cache_misses"] == 2
    assert counters["decode.cache_hits"] == 1


def test_clamp_equivalent_regions_share_one_tile_entry(tmp_path):
    path, img = _write_region_jp2(tmp_path, "cl.jp2")   # 64x64
    sink = Metrics()
    reader = _reader(cache_mb=4, metrics=sink)
    a = reader.read(path, region=(48, 48, 32, 32))      # clamps to 16x16
    b = reader.read(path, region=(48, 48, 16, 16))      # the clamped twin
    assert np.array_equal(a, img[48:64, 48:64])
    assert a is b
    counters = sink.report()["counters"]
    assert counters["decode.cache_misses"] == 1
    assert counters["decode.cache_hits"] == 1
    # Reversed arrival order hits too (dims now known up front).
    assert reader.read(path, region=(48, 48, 999, 999)) is a
    assert sink.report()["counters"]["decode.cache_hits"] == 2


def test_index_tier_builds_once_per_file_identity(tmp_path):
    path, _ = _write_region_jp2(tmp_path, "i.jp2")
    sink = Metrics()
    reader = _reader(cache_mb=4, metrics=sink)
    for region in ((0, 0, 16, 16), (16, 16, 16, 16), (32, 0, 16, 16)):
        reader.read(path, region=region)
    rep = sink.report()
    assert rep["counters"]["decode.index_cache_misses"] == 1
    assert rep["counters"]["decode.index_cache_hits"] == 2
    assert rep["stages"]["decode.index_build"]["count"] == 1
    path_b, _ = _write_region_jp2(tmp_path, "i2.jp2", seed=10)
    os.replace(path_b, path)
    os.utime(path, ns=(1, 1))
    reader.read(path, region=(0, 0, 16, 16))
    assert sink.report()["counters"]["decode.index_cache_misses"] == 2


def test_index_tier_builds_are_single_flight(tmp_path, monkeypatch):
    """Concurrent cold reads of one file pay for one index build."""
    path, img = _write_region_jp2(tmp_path, "sf.jp2")
    sink = Metrics()
    reader = _reader(cache_mb=4, metrics=sink)
    builds = []
    real_build = reader_mod.build_index

    def slow_build(data):
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return real_build(data)

    monkeypatch.setattr(reader_mod, "build_index", slow_build)
    results = {}

    def hit(i):
        results[i] = reader.read(path, region=(0, 0, 16, 16))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(builds) == 1
    assert len(results) == 4
    for arr in results.values():
        assert np.array_equal(arr, img[0:16, 0:16])
    assert sink.report()["counters"]["decode.index_cache_misses"] == 1
    assert not reader._index_builds        # no leaked in-flight entries


def test_index_waiter_honors_decode_services_check(tmp_path, monkeypatch):
    """A waiter parked behind a slow index builder polls its thread's
    installed check (a deadline) instead of waiting the builder out."""
    path, _ = _write_region_jp2(tmp_path, "dl.jp2")
    reader = _reader(cache_mb=4)
    real_build = reader_mod.build_index
    started = threading.Event()

    def slow_build(data):
        started.set()
        time.sleep(3)
        return real_build(data)

    monkeypatch.setattr(reader_mod, "build_index", slow_build)

    class Expired(Exception):
        pass

    def expired_check():
        raise Expired()

    errors = {}

    def waiter():
        with t1_dec.decode_services(check=expired_check):
            t0 = time.monotonic()
            try:
                reader.read(path, region=(0, 0, 16, 16))
            except Expired:
                errors["waited"] = time.monotonic() - t0

    tb = threading.Thread(
        target=lambda: reader.read(path, region=(0, 0, 16, 16)))
    tb.start()
    assert started.wait(timeout=10)
    tw = threading.Thread(target=waiter)
    tw.start()
    tw.join(timeout=10)
    tb.join(timeout=30)
    assert not tw.is_alive() and not tb.is_alive()
    assert "waited" in errors and errors["waited"] < 2


def test_dims_probes_once_per_file_identity(tmp_path, monkeypatch):
    path, img = _write_region_jp2(tmp_path, "dm.jp2")
    reader = _reader(cache_mb=4)
    calls = []
    real_probe = reader_mod._probe

    def counting_probe(data):
        calls.append(1)
        return real_probe(data)

    monkeypatch.setattr(reader_mod, "_probe", counting_probe)
    assert reader.dims(path) == (img.shape[1], img.shape[0])
    assert reader.dims(path) == (img.shape[1], img.shape[0])
    assert len(calls) == 1
    reader.read(path, region=(0, 0, 16, 16))     # shares the dims cache
    assert len(calls) == 1


def test_index_tier_entry_bound_evicts(tmp_path):
    sink = Metrics()
    reader = _reader(cache_mb=4, metrics=sink, index_entries=2)
    paths = [_write_region_jp2(tmp_path, f"e{i}.jp2", size=32,
                               seed=20 + i)[0] for i in range(3)]
    for p in paths:
        reader.read(p, region=(0, 0, 16, 16))
    assert sink.report()["counters"]["decode.index_cache_evictions"] == 1
    reader.read(paths[0], region=(16, 0, 16, 16))   # evicted: rebuilds
    assert sink.report()["counters"]["decode.index_cache_misses"] == 4


def test_full_reads_skip_the_index_tier(tmp_path):
    path, _ = _write_region_jp2(tmp_path, "f.jp2")
    sink = Metrics()
    _reader(cache_mb=4, metrics=sink).read(path)
    assert "decode.index_cache_misses" not in sink.report()["counters"]


def test_reset_caches_drops_tiles_keeps_index(tmp_path):
    path, _ = _write_region_jp2(tmp_path, "z.jp2")
    sink = Metrics()
    reader = _reader(cache_mb=4, metrics=sink)
    reader.read(path, region=(0, 0, 16, 16))
    reader.reset_caches(tiles=True, index=False)
    reader.read(path, region=(0, 0, 16, 16))
    counters = sink.report()["counters"]
    assert counters["decode.cache_misses"] == 2
    assert counters["decode.index_cache_hits"] == 1
    reader.reset_caches(tiles=True, index=True)
    reader.read(path, region=(0, 0, 16, 16))
    assert sink.report()["counters"]["decode.index_cache_misses"] == 2


def test_cache_hammer_keeps_invariants():
    """Eight threads on a short switch interval replay seeded put/get
    schedules on both tiers: the byte ledger equals the surviving
    entries, budgets hold, and per-call eviction counts sum to the
    totals."""
    import sys

    tiles = _DecodeCache(64 * 1024)
    index = _IndexCache(max_entries=8)
    n_threads, n_ops = 8, 400
    start = threading.Barrier(n_threads)
    evicted_by_thread = [0] * n_threads

    def worker(tid):
        rng = np.random.default_rng(1000 + tid)
        start.wait()
        evicted = 0
        for _ in range(n_ops):
            op = rng.integers(0, 4)
            key = ("t", int(rng.integers(0, 32)))
            if op == 0:
                evicted += tiles.put(key, np.zeros(
                    int(rng.integers(1, 4096)), dtype=np.uint8))
            elif op == 1:
                got = tiles.get(key)
                if got is not None:
                    assert not got.flags.writeable
            elif op == 2:
                evicted += index.put(("i", int(rng.integers(0, 16))),
                                     object())
            else:
                index.get(("i", int(rng.integers(0, 16))))
        evicted_by_thread[tid] = evicted

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert tiles.nbytes == sum(a.nbytes for a in tiles._entries.values())
    assert tiles.nbytes <= 64 * 1024
    assert len(index) <= index.max_entries
    assert sum(evicted_by_thread) == tiles.evictions + index.evictions


# --- what the reader refuses ----------------------------------------------

def test_read_id_and_missing_files(tmp_path, monkeypatch):
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    reader = _reader(cache_mb=4)
    with pytest.raises(ConverterError):
        reader.read(str(tmp_path / "absent.jpx"))
    with pytest.raises(ConverterError):
        reader.probe(str(tmp_path / "absent.jpx"))
    with pytest.raises(ConverterError):
        reader.dims(str(tmp_path / "absent.jpx"))
    with pytest.raises(ConverterError):
        reader.read_id("ark:/21198/none")
    assert reader_mod.derivative_path("ark:/21198/none") is None
    dest = reader_mod.output_path("ark:/21198/z1", ".jpx")
    path, img = _write_jp2(tmp_path, "src.jp2")
    os.replace(path, dest)
    assert reader_mod.derivative_path("ark:/21198/z1") == dest
    np.testing.assert_array_equal(reader.read_id("ark:/21198/z1"), img)
    bad = tmp_path / "bad.jpx"
    bad.write_bytes(b"not a jp2 at all")
    with pytest.raises(DecodeError):
        reader.read(str(bad))


def test_scheduler_and_coefficient_reads(tmp_path):
    """A reader with a CPU scheduler: a miss (full and region, pixels
    and coefficients) runs as an admitted read job and equals the direct
    read; a hit does not go through the scheduler."""
    from bucketeer_tpu_torch.engine.scheduler import EncodeScheduler

    path, img = _write_region_jp2(tmp_path, "u.jp2")
    sched = EncodeScheduler(device="cpu", window_s=0)
    sink = Metrics()
    sched.set_metrics_sink(sink)
    reader = _reader(cache_mb=4, scheduler=sched)
    direct = _reader(cache_mb=0)
    try:
        for kw in ({}, {"region": (10, 20, 30, 25)}, {"reduce": 1}):
            got = reader.read(path, **kw)
            np.testing.assert_array_equal(got, direct.read(path, **kw))
            assert reader.read(path, **kw) is got            # a hit
        cs = reader.read_coefficients(path)
        ref = decode_to_coefficients(open(path, "rb").read(), device="cpu")
        assert cs.reversible and all(t.device.type == "cpu"
                                     for t in cs.bands.values())
        for key, band in ref.bands.items():
            assert torch.equal(cs.bands[key], band)
    finally:
        sched.close()
    np.testing.assert_array_equal(direct.read(path), img)
    rep = sink.report()
    assert rep["stages"]["decode.queue_wait"]["count"] == 4   # misses only
    assert rep["stages"]["decode.request"]["count"] == 4


def test_scheduler_read_is_granted_before_a_queued_encode(tmp_path,
                                                          monkeypatch):
    """With the scheduler's one slot held, a queued encode and then a
    read: the read (PRIORITY_READ) is granted first."""
    from bucketeer_tpu_torch.engine.scheduler import EncodeScheduler

    path, img = _write_jp2(tmp_path, "p.jp2")
    sched = EncodeScheduler(device="cpu", max_concurrent=1, window_s=0)
    reader = _reader(cache_mb=0, scheduler=sched)
    order = []
    real = reader_mod.decode

    def decode(*a, **kw):
        order.append("read")
        return real(*a, **kw)

    monkeypatch.setattr(reader_mod, "decode", decode)
    release, holding = threading.Event(), threading.Event()

    def hold():
        holding.set()
        release.wait(timeout=60)

    out = {}
    threads = [threading.Thread(target=lambda: sched.submit(hold))]
    threads[0].start()
    try:
        assert holding.wait(timeout=60)
        for name, fn in (
                ("encode", lambda: sched.submit(
                    lambda: order.append("encode"))),
                ("read", lambda: out.setdefault("px", reader.read(path)))):
            n = sched.stats()["waiting"] + 1
            t = threading.Thread(target=fn, name=name)
            t.start()
            threads.append(t)
            deadline = time.monotonic() + 60
            while sched.stats()["waiting"] < n:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        release.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        release.set()
        sched.close()
    assert order == ["read", "encode"]
    np.testing.assert_array_equal(out["px"], img)


def test_card_without_cuda_raises(monkeypatch):
    """The reader defaults to the card and does not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        CudaReader()
