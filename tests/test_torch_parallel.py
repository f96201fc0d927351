"""The port's mesh path against the JAX package's, on the CPU.

The JAX side runs on the 8-device CPU mesh that conftest.py forces; the
port's side on meshes of 8 ``"cpu"`` entries (1x8 spatial, 4x2 data x
tile), at the JAX tests' sizes (tests/test_parallel.py). Lossless work
is integer and must be exact. The port's 9/7 lifting is the elementwise
form of its single-device DWT, so the sharded 9/7 equals the port's own
single-device 9/7 exactly; against JAX's it is held at the JAX test's
tolerance (rtol 1e-5, atol 1e-3), and the lossy transform at JAX's
max |delta| <= 1 index and < 1 % of samples differing.
"""
import inspect
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu.codec.encoder import EncodeParams as JParams
from bucketeer_tpu.codec.pipeline import make_plan as j_make_plan
from bucketeer_tpu.converters import tpu as j_tpu
from bucketeer_tpu.parallel import make_mesh as j_make_mesh
from bucketeer_tpu.parallel import run_tiles_sharded as j_run_sharded
from bucketeer_tpu.parallel import sharded_dwt as j_sdwt
from bucketeer_tpu.parallel import sharded_dwt2d_forward as j_sharded_dwt
from bucketeer_tpu_torch import config as t_cfg
from bucketeer_tpu_torch.codec import encoder as t_encoder
from bucketeer_tpu_torch.codec.dwt import dwt2d_forward as t_dwt
from bucketeer_tpu_torch.codec.encoder import EncodeParams as TParams
from bucketeer_tpu_torch.codec.pipeline import make_plan as t_make_plan
from bucketeer_tpu_torch.codec.pipeline import run_tiles as t_run_tiles
from bucketeer_tpu_torch.converters import Conversion, CudaConverter
from bucketeer_tpu_torch.converters import cuda as t_cuda
from bucketeer_tpu_torch.engine.scheduler import EncodeScheduler
from bucketeer_tpu_torch.parallel import batch as t_pbatch
from bucketeer_tpu_torch.parallel import mesh as t_pmesh
from bucketeer_tpu_torch.parallel import sharded_dwt as t_sdwt
from bucketeer_tpu_torch.parallel import (make_mesh, run_tiles_sharded,
                                          sharded_dwt2d_forward, unshard,
                                          visible_devices)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def meshes():
    """(port, JAX) mesh pairs: 1 x 8 all spatial, 4 x 2 data x tile."""
    return {"1x8": (make_mesh(CPU8, tile_parallel=8),
                    j_make_mesh(tile_parallel=8)),
            "4x2": (make_mesh(CPU8, tile_parallel=2),
                    j_make_mesh(tile_parallel=2))}


def _cpu_entries(n):
    return lambda device="cuda": [torch.device("cpu")] * n


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# --- the mesh ----------------------------------------------------------

def test_mesh_axes(meshes):
    for name, (mesh, jmesh) in meshes.items():
        assert mesh.shape == dict(jmesh.shape), name
        assert mesh.size == jmesh.devices.size == 8
        assert mesh.device_list == [torch.device("cpu")] * 8
        assert mesh.device_type == "cpu"
    assert make_mesh(CPU8, tile_parallel=2).shape == {"data": 4, "tile": 2}
    with pytest.raises(ValueError) as t_err:
        make_mesh(CPU8, tile_parallel=3)
    with pytest.raises(ValueError) as j_err:
        j_make_mesh(tile_parallel=3)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="one device type"):
        make_mesh(["cpu", "cuda:0"])


def test_mesh_splits_and_puts_back(meshes):
    mesh = meshes["4x2"][0]
    x = torch.arange(8 * 6 * 5).reshape(8, 6, 5)
    parts = t_pmesh.batch_sharding(x, mesh)
    assert [p.shape[0] for p in parts] == [2] * 4
    assert torch.equal(unshard(parts), x)
    rows = t_pmesh.row_sharding(x, mesh, dim=-2)
    assert [p.shape[-2] for p in rows] == [3, 3]
    assert torch.equal(unshard(rows, dim=-2), x)
    assert all(torch.equal(c, x) for c in t_pmesh.replicated(x, mesh))
    with pytest.raises(ValueError, match="split evenly"):
        t_pmesh.batch_sharding(x[:7], mesh)


def test_can_row_shard():
    can = t_sdwt.can_row_shard
    assert can(128, 2, 8)         # 16 rows/shard, 4/level-2
    assert not can(128, 2, 1)     # no point with one shard
    assert not can(100, 2, 8)     # not divisible
    assert not can(64, 3, 8)      # 1 row at the coarsest level
    for h in (64, 96, 128, 256, 384, 512, 1536, 4096):
        for levels in range(1, 7):
            for n in (1, 2, 4, 8):
                assert can(h, levels, n) == j_sdwt.can_row_shard(
                    h, levels, n), (h, levels, n)


# --- the sharded DWT ---------------------------------------------------

def test_halo_pad_takes_neighbour_rows_and_reflects_at_the_edges():
    x = torch.arange(32 * 3).reshape(32, 3)
    shards = list(torch.chunk(x, 4))
    padded = t_sdwt._halo_pad(shards)
    H = t_sdwt.HALO
    for i, p in enumerate(padded):
        lo, hi = i * 8 - H, (i + 1) * 8 + H
        rows = np.abs(np.arange(lo, hi))               # top reflection
        rows = np.where(rows > 31, 62 - rows, rows)    # bottom reflection
        assert torch.equal(p, x[torch.as_tensor(rows)]), i


@pytest.mark.parametrize("reversible", [True, False])
def test_sharded_dwt_matches_jax_and_single_device(rng, meshes,
                                                   reversible):
    """256 x 64 over 1 x 8 at 2 levels: 8 rows per shard at the
    coarsest level, so ``torch.roll`` wraps into rows that lie in the
    halos of every level."""
    mesh, jmesh = meshes["1x8"]
    h, w, levels = 256, 64, 2
    x = rng.integers(-1000, 1000, size=(h, w)).astype(np.int32)
    if not reversible:
        x = x.astype(np.float32)
    ll, bands = sharded_dwt2d_forward(torch.from_numpy(x), levels,
                                      reversible, mesh)
    ref_ll, ref_bands = t_dwt(torch.from_numpy(x), levels, reversible)
    j_ll, j_bands = j_sharded_dwt(jnp.asarray(x), levels, reversible,
                                  jmesh)
    pairs = [(ll, ref_ll, j_ll)] + [
        (got[k], ref[k], jb[k]) for got, ref, jb in
        zip(bands, ref_bands, j_bands) for k in ("HL", "LH", "HH")]
    for got, ref, jref in pairs:
        # Exactly the port's single-device transform, both wavelets.
        np.testing.assert_array_equal(_np(got), _np(ref))
        if reversible:
            np.testing.assert_array_equal(_np(got), np.asarray(jref))
        else:
            np.testing.assert_allclose(_np(got), np.asarray(jref),
                                       rtol=1e-5, atol=1e-3)


def test_sharded_dwt_multicomponent(rng, meshes):
    mesh, jmesh = meshes["1x8"]
    x = rng.integers(-500, 500, size=(3, 128, 32)).astype(np.int32)
    ll, _ = sharded_dwt2d_forward(torch.from_numpy(x), 1, True, mesh)
    j_ll, _ = j_sharded_dwt(jnp.asarray(x), 1, True, jmesh)
    ref_ll, _ = t_dwt(torch.from_numpy(x), 1, True)
    np.testing.assert_array_equal(_np(ll), np.asarray(j_ll))
    np.testing.assert_array_equal(_np(ll), _np(ref_ll))


def test_sharded_dwt_refuses_too_few_rows_as_jax_does(meshes):
    """64 rows over 8 shards at 2 levels leave 4 rows per shard at the
    second level, fewer than HALO + 1: both packages raise."""
    x = np.zeros((64, 16), np.int32)
    with pytest.raises(ValueError, match="shard rows 4"):
        sharded_dwt2d_forward(torch.from_numpy(x), 2, True,
                              meshes["1x8"][0])
    with pytest.raises(ValueError, match="shard rows 4"):
        j_sharded_dwt(jnp.asarray(x), 2, True, meshes["1x8"][1])


# --- data-parallel tile batches and the sharded transform -------------

@pytest.mark.parametrize("shape,n,lossless", [
    ((64, 64, 3, 3), 10, False),      # 10 tiles pad to 12 over 4
    ((32, 32, 1, 2), 8, True)])
def test_run_tiles_sharded_matches_jax_and_run_tiles(rng, meshes, shape,
                                                     n, lossless):
    mesh, jmesh = meshes["4x2"]
    th, tw, comps, levels = shape
    dims = (n, th, tw, comps) if comps > 1 else (n, th, tw)
    tiles = rng.integers(0, 256, size=dims).astype(np.uint8)
    args = (th, tw, comps, levels, lossless, 8)
    got = run_tiles_sharded(t_make_plan(*args), tiles, mesh)
    np.testing.assert_array_equal(
        got, t_run_tiles(t_make_plan(*args), tiles, device="cpu"))
    ref = j_run_sharded(j_make_plan(*args), tiles, jmesh)
    if lossless:
        np.testing.assert_array_equal(got, ref)
    else:
        diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        assert diff.max() <= 1 and (diff != 0).mean() < 0.01


@pytest.mark.parametrize("lossless", [True, False])
def test_sharded_transform_tile_matches_jax_and_run_tiles(rng, meshes,
                                                          lossless):
    """The prologue (level shift, RCT/ICT, fixed-point quantization) is
    pipeline's own: the mesh path equals run_tiles exactly. Against
    JAX, lossy indices may move by one LSB (float rounding, C.3)."""
    mesh, jmesh = meshes["1x8"]
    args = (128, 96, 3, 2, lossless, 8)
    tile = rng.integers(0, 256, (128, 96, 3)).astype(np.uint8)
    got = t_sdwt.sharded_transform_tile(t_make_plan(*args), tile, mesh)
    np.testing.assert_array_equal(
        got, t_run_tiles(t_make_plan(*args), tile[None], device="cpu")[0])
    ref = j_sdwt.sharded_transform_tile(j_make_plan(*args), tile, jmesh)
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    if lossless:
        assert diff.max() == 0
    else:
        assert diff.max() <= 1 and (diff != 0).mean() < 0.01
    with pytest.raises(ValueError, match="cannot shard"):
        t_sdwt.sharded_transform_tile(t_make_plan(100, 96, 3, 2, True, 8),
                                      tile[:100], mesh)


# --- mesh encodes: the product path -----------------------------------

@pytest.mark.parametrize("kind", ["spatial", "tiled"])
def test_mesh_encode_bytes_equal_jax_and_single_device(rng, meshes, kind):
    """Lossless mesh encodes are byte-identical to the JAX package's
    mesh encode and to the port's single-device encode (the host
    Tier-1, which codes as the fused path does)."""
    if kind == "spatial":
        mesh, jmesh = meshes["1x8"]
        img = rng.integers(0, 256, size=(128, 96), dtype=np.uint8)
        kw = dict(lossless=True, levels=2)
    else:
        mesh, jmesh = meshes["4x2"]
        img = rng.integers(0, 256, size=(160, 160, 3), dtype=np.uint8)
        kw = dict(lossless=True, levels=2, tile_size=64)
    got = t_encoder.encode_jp2(img, 8, TParams(**kw), mesh=mesh,
                               device="cpu")
    assert got == j_encoder.encode_jp2(img, 8, JParams(**kw), mesh=jmesh)
    assert got == t_encoder.encode_jp2(img, 8, TParams(**kw,
                                                       device_mq=False),
                                       device="cpu")
    # Through a scheduler: the same bytes, from the request thread.
    sched = EncodeScheduler(device="cpu", devices=1)
    try:
        assert sched.encode_jp2(img, 8, TParams(**kw), mesh=mesh) == got
    finally:
        sched.close()


def test_mesh_of_another_device_type_raises(meshes):
    img = np.zeros((128, 96), np.uint8)
    params = TParams(lossless=True, levels=2)
    with pytest.raises(ValueError, match="mesh of cpu"):
        t_encoder.encode_jp2(img, 8, params, mesh=meshes["1x8"][0],
                             device="cuda")
    sched = EncodeScheduler(device="cpu", devices=1)
    try:
        with pytest.raises(ValueError, match="mesh encode on cuda"):
            sched.encode_jp2(img, 8, params,
                             mesh=make_mesh(["cuda:0"] * 2, 2))
    finally:
        sched.close()


def test_make_mesh_defaults_to_the_cards():
    assert inspect.signature(
        visible_devices).parameters["device"].default == "cuda"
    assert visible_devices("cpu") == [torch.device("cpu")]
    if torch.cuda.is_available():
        pytest.skip("checks the answer of a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        visible_devices()


# --- the converter's routing -------------------------------------------

def _tiff(tmp_path, img, name):
    src = tmp_path / f"{name}.tif"
    Image.fromarray(img).save(src)
    return str(src)


def test_converter_routes_through_mesh(rng, monkeypatch, tmp_path):
    """An over-threshold tiled image on an 8-entry host goes through
    run_tiles_sharded on a data mesh, and the derivative decodes to the
    source exactly."""
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    monkeypatch.setattr(t_pmesh, "visible_devices", _cpu_entries(8))
    img = rng.integers(0, 256, size=(640, 640), dtype=np.uint8)
    calls = []
    orig = t_pbatch.run_tiles_sharded

    def spy(plan, tiles, mesh):
        calls.append(dict(mesh.shape))
        return orig(plan, tiles, mesh)

    monkeypatch.setattr(t_pbatch, "run_tiles_sharded", spy)
    out = CudaConverter(device="cpu", mesh_min_pixels=1).convert(
        "map", _tiff(tmp_path, img, "map"), Conversion.LOSSLESS)
    assert calls and calls[0] == {"data": 8, "tile": 1}
    np.testing.assert_array_equal(np.asarray(Image.open(out)), img)


def test_converter_routes_a_single_tile_spatially(rng, monkeypatch,
                                                  tmp_path):
    """A single row-shardable tile (512 rows, 6 levels, 2 entries: 256
    rows per shard) goes through sharded_transform_tile on a 1 x 2
    mesh; its file equals the unrouted rows-mode convert's."""
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    monkeypatch.setattr(t_pmesh, "visible_devices", _cpu_entries(2))
    img = rng.integers(0, 256, size=(512, 384), dtype=np.uint8)
    src = _tiff(tmp_path, img, "sheet")
    calls = []
    orig = t_sdwt.sharded_transform_tile

    def spy(plan, tile, mesh):
        calls.append(dict(mesh.shape))
        return orig(plan, tile, mesh)

    monkeypatch.setattr(t_sdwt, "sharded_transform_tile", spy)
    routed = open(CudaConverter(device="cpu", mesh_min_pixels=1).convert(
        "sheet", src, Conversion.LOSSLESS), "rb").read()
    assert calls == [{"data": 1, "tile": 2}]
    plain = open(CudaConverter(device="cpu", device_mq=False,
                               device_cxd=False).convert(
        "sheet", src, Conversion.LOSSLESS), "rb").read()
    assert calls == [{"data": 1, "tile": 2}]
    assert routed == plain
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(
        routed))), img)


def test_converter_mesh_threshold_respected(rng, monkeypatch, tmp_path):
    """Below the threshold the converter stays on the single-device
    pipeline."""
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    monkeypatch.setattr(t_pmesh, "visible_devices", _cpu_entries(8))
    img = rng.integers(0, 256, size=(96, 96), dtype=np.uint8)

    def boom(*a, **k):
        raise AssertionError("mesh path taken below threshold")

    monkeypatch.setattr(t_pbatch, "run_tiles_sharded", boom)
    monkeypatch.setattr(t_sdwt, "sharded_transform_tile", boom)
    conv = CudaConverter(device="cpu", device_mq=False, device_cxd=False,
                         mesh_min_pixels=10_000_000)
    out = conv.convert("small", _tiff(tmp_path, img, "small"),
                       Conversion.LOSSLESS)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), img)
    assert t_cuda.DEFAULT_MESH_MIN_PIXELS == j_tpu.DEFAULT_MESH_MIN_PIXELS
    assert CudaConverter(device="cpu").mesh_min_pixels == \
        t_cuda.DEFAULT_MESH_MIN_PIXELS


def test_choose_mesh_rules(monkeypatch):
    """JAX's rules (converters/tpu.py _choose_mesh) over the visible
    devices of the converter's type."""
    conv = CudaConverter(device="cpu", mesh_min_pixels=100)
    tiled = TParams(levels=6, tile_size=512)
    single = TParams(levels=6, tile_size=None)
    # The CPU is one entry: a one-entry list never routes.
    assert conv._choose_mesh(4096, 4096, tiled) is None
    monkeypatch.setattr(t_pmesh, "visible_devices", _cpu_entries(1))
    assert conv._choose_mesh(4096, 4096, tiled) is None
    monkeypatch.setattr(t_pmesh, "visible_devices", _cpu_entries(4))
    assert conv._choose_mesh(9, 10, tiled) is None          # below
    assert conv._choose_mesh(4096, 4096, tiled).shape == {
        "data": 4, "tile": 1}
    assert conv._choose_mesh(1024, 1000, single).shape == {
        "data": 1, "tile": 4}                               # 256 rows each
    assert conv._choose_mesh(500, 500, single) is None      # not shardable
    assert CudaConverter(device="cpu", mesh_min_pixels=0)._choose_mesh(
        4096, 4096, tiled) is None


def test_batch_worker_sets_the_threshold_from_config():
    from bucketeer_tpu_torch.engine.batch import BatchConverterWorker

    conv = CudaConverter(device="cpu")
    config = t_cfg.Config.load(overrides={t_cfg.MESH_MIN_PIXELS: 1234})
    BatchConverterWorker(conv, None, None, config)
    assert conv.mesh_min_pixels == 1234
    untouched = CudaConverter(device="cpu")
    BatchConverterWorker(untouched, None, None, t_cfg.Config.load())
    assert untouched.mesh_min_pixels == t_cuda.DEFAULT_MESH_MIN_PIXELS
