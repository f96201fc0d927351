"""The port's CX/D-split Tier-1 on the CPU: the device-side scan and its
host streams (codec/cxd.py ``run_cxd``), the host MQ replay
(codec/t1_batch.py ``encode_cxd``, the port's own C++ library), and the
split end to end through encode_jp2 and CudaConverter. Held against the
JAX package's split, its default encode and the port's fused path."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import cxd as j_cxd
from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu.codec import t1_batch as j_t1_batch
from bucketeer_tpu_torch.codec import cxd as t_cxd
from bucketeer_tpu_torch.codec import encoder as t_encoder
from bucketeer_tpu_torch.codec import t1_batch as t_t1_batch
from bucketeer_tpu_torch.converters import Conversion, CudaConverter

SPLIT = {"device_mq": False, "device_cxd": True}


def _chunk():
    """The five-block chunk of tests/test_cxd.py's run_cxd test: random
    extents and bands, an all-zero block, a partly floored block and one
    floored away entirely."""
    rng = np.random.default_rng(20261016)
    n = 5
    blocks = np.zeros((n, 64, 64), np.int32)
    nbps = np.zeros(n, np.int32)
    hs = rng.integers(1, 65, n).astype(np.int32)
    ws = rng.integers(1, 65, n).astype(np.int32)
    for i in range(n):
        h, w = hs[i], ws[i]
        mags = ((rng.random((h, w)) < 0.3)
                * rng.integers(0, 1 << 5, size=(h, w)))
        if i == 3:
            mags[:] = 0
        blocks[i, :h, :w] = mags * np.where(rng.random((h, w)) < 0.5, -1, 1)
        nbps[i] = int(mags.max()).bit_length()
    floors = np.array([0, 1, 0, 0, 5], np.int32)      # block 4: floored away
    bands = ["LL", "HL", "LH", "HH", "LL"]
    return blocks, nbps, floors, bands, hs, ws


@pytest.fixture(scope="module")
def split_chunk():
    blocks, nbps, floors, bands, hs, ws = _chunk()
    ref = j_cxd.run_cxd(jnp.asarray(blocks), nbps, floors, bands, hs, ws,
                        5, 0)
    got = t_cxd.run_cxd(torch.as_tensor(blocks), nbps, floors, bands, hs,
                        ws, 0)
    return ref, got


def _block_syms(streams, b):
    p0, p1 = streams.pass_offsets[b], streams.pass_offsets[b + 1]
    n_syms = int(streams.pass_nsyms[p0:p1].sum())
    start = int(streams.row_offsets[b])
    rows = -(-n_syms // t_cxd.SYMS_PER_ROW)
    return t_cxd.unpack6(streams.payload[start:start + rows], n_syms)


def _fields(blk):
    return (blk.data, blk.n_bitplanes,
            [(p.pass_type, p.bitplane, p.cum_length, p.dist_reduction)
             for p in blk.passes])


def test_run_cxd_streams_match_jax(split_chunk):
    """Pass tables exactly, and each block's symbols over its n_syms."""
    ref, got = split_chunk
    for name in ("row_offsets", "nbps", "pass_offsets", "pass_types",
                 "pass_planes", "pass_nsyms", "pass_dists"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)
    assert got.total_syms == ref.total_syms > 0
    assert got.payload.shape == ref.payload.shape
    for b in range(len(got.nbps)):
        np.testing.assert_array_equal(_block_syms(got, b),
                                      _block_syms(ref, b), err_msg=f"{b}")


def test_host_replay_matches_jax(split_chunk):
    """The port's C++ replay of its own streams gives the JAX package's
    code-blocks (its replay of its streams), field for field."""
    ref, got = split_chunk
    want = j_t1_batch.encode_cxd(ref)
    have = t_t1_batch.encode_cxd(got)
    assert [_fields(b) for b in have] == [_fields(b) for b in want]
    assert have[3].data == b"" and have[4].n_bitplanes == 0
    assert have[0].data and have[0].passes


def test_python_replay_equals_native(split_chunk):
    _, got = split_chunk
    native = t_t1_batch.encode_cxd(got)
    for b, blk in enumerate(native):
        p0, p1 = got.pass_offsets[b], got.pass_offsets[b + 1]
        py = t_cxd.replay_block(_block_syms(got, b), int(got.nbps[b]),
                                int(p1 - p0), got.pass_types[p0:p1],
                                got.pass_planes[p0:p1],
                                got.pass_nsyms[p0:p1],
                                got.pass_dists[p0:p1])
        assert _fields(py) == _fields(blk), f"block {b}"


def test_unpack6_inverts_pack6():
    rng = np.random.default_rng(7)
    syms = rng.integers(0, 64, size=(2, 1024)).astype(np.uint8)
    packed = t_cxd.pack6(torch.as_tensor(syms)).numpy()
    assert packed.shape == (2, 768)                  # 6 bits a symbol
    for b in range(2):
        np.testing.assert_array_equal(t_cxd.unpack6(packed[b], 1000),
                                      syms[b, :1000])


def _photo(seed, h, w, comps=1):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 120 + 80 * np.sin(x / 17.0) * np.cos(y / 13.0)
    img = base[..., None] + rng.normal(0, 8, (h, w, comps))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if comps == 1 else img


@pytest.mark.parametrize("h,w,comps,kw", [
    (64, 64, 1, {}),
    (96, 64, 3, {"levels": 2, "tile_size": 64}),
])
def test_split_lossless_equals_jax_default(h, w, comps, kw):
    """Lossless split bytes equal the JAX package's default encode (its
    split, legacy and MQ files are identical, tests/test_cxd.py)."""
    img = _photo(h + w, h, w, comps)
    ref = j_encoder.encode_jp2(img, 8, j_encoder.EncodeParams(
        lossless=True, **kw))
    stats = {}
    got = t_encoder.encode_jp2(img, 8, t_encoder.EncodeParams(
        lossless=True, **kw, **SPLIT), device="cpu", stats=stats)
    assert got == ref
    assert stats["symbols"] > 0 and stats["bytes"] > 0


def test_split_lossy_equals_fused():
    """Rate-targeted lossy (floors, PCRD, margin retries, distortion
    rescale): the split's bytes equal the fused path's."""
    img = _photo(3, 64, 64, 3)
    params = t_encoder.EncodeParams(lossless=False, levels=2, rate=1.5,
                                    n_layers=3, base_delta=0.5,
                                    device_mq=True)
    fused_stats, split_stats = {}, {}
    fused = t_encoder.encode_jp2(img, 8, params, device="cpu",
                                 stats=fused_stats)
    split = t_encoder.encode_jp2(img, 8, dataclasses.replace(params,
                                                             **SPLIT),
                                 device="cpu", stats=split_stats)
    assert split == fused
    assert split_stats == fused_stats


def test_converter_split_equals_default(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    src = tmp_path / "src.tif"
    Image.fromarray(_photo(4, 48, 40, 3)).save(src)
    files = []
    # The card's default, the fused Tier-1, against the split.
    for conv in (CudaConverter(device="cpu", device_mq=True),
                 CudaConverter(device="cpu", **SPLIT)):
        out = conv.convert("ark:/1/split", str(src), Conversion.LOSSLESS)
        with open(out, "rb") as fh:
            files.append(fh.read())
    assert files[0] == files[1]


def test_host_tier1_still_raises():
    """device_mq=False without device_cxd once raised (the host Tier-1
    was not ported); it now codes on the host Tier-1, with the fused
    path's bytes."""
    img = _photo(5, 32, 32)
    host = t_encoder.encode_jp2(img, 8,
                                t_encoder.EncodeParams(device_mq=False),
                                device="cpu")
    assert host == t_encoder.encode_jp2(
        img, 8, t_encoder.EncodeParams(device_mq=True), device="cpu")
