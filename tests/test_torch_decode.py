"""The port's JP2 decode (bucketeer_tpu_torch.codec.decode, on the CPU)
against the JAX package's decoder on the same bytes: lossless reads
equal the JAX decode and the source exactly (both encoders' files, every
progression, reduce, layers, raw and boxed streams), lossy reads have
identical Tier-1 output and samples within +-1, and malformed input
raises the typed errors."""
import struct

import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu.codec import mq as j_mq
from bucketeer_tpu.codec.decode import DecodeError as JDecodeError
from bucketeer_tpu.codec.decode import decode as j_decode
from bucketeer_tpu.codec.decode import decoder as j_decoder
from bucketeer_tpu.codec.decode import parser as j_parser
from bucketeer_tpu.codec.decode import probe as j_probe
from bucketeer_tpu.codec.encoder import EncodeParams
from bucketeer_tpu.server.metrics import Metrics
from bucketeer_tpu_torch.codec import encoder as t_encoder
from bucketeer_tpu_torch.codec import mq as t_mq
from bucketeer_tpu_torch.codec.decode import (DecodeError, InvalidParam,
                                              decode, probe,
                                              set_metrics_sink)
from bucketeer_tpu_torch.codec.decode import decoder as t_decoder
from bucketeer_tpu_torch.codec.decode import parser as t_parser


def _img(seed, shape, depth=8):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if depth <= 8 else np.uint16
    return rng.integers(0, 1 << depth, shape).astype(dtype)


def _smooth(seed, h, w, comps=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 80 * np.sin(x / 11.0) * np.cos(y / 7.0)
    noise = rng.normal(0, 6, (h, w, comps) if comps > 1 else (h, w))
    return np.clip((base[..., None] if comps > 1 else base) + noise,
                   0, 255).astype(np.uint8)


def _quiet(seed, shape):
    """Low-amplitude 8-bit content: few coded bit-planes, so the port's
    encoder (its kernels' plain versions on the CPU) writes it quickly."""
    rng = np.random.default_rng(seed)
    return (100 + rng.integers(0, 8, shape)).astype(np.uint8)


@pytest.fixture(scope="module")
def port_file():
    """A two-tile RGB file the port writes on the CPU with the reference
    recipe (RPCL, SOP/EPH, PLT, R tile-parts, 6 layers), JPX-boxed."""
    img = _quiet(31, (72, 40, 3))
    params = t_encoder.EncodeParams.kakadu_recipe(lossless=True)
    params.levels, params.tile_size = 3, 64
    return img, t_encoder.encode_jp2(img, 8, params, jpx=True,
                                     device="cpu")


def _lossless_equal(data, img, **kw):
    got = decode(data, device="cpu", **kw)
    ref = j_decode(data, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if img is not None:
        np.testing.assert_array_equal(got.reshape(img.shape), img)
    return got


@pytest.mark.parametrize("shape,levels,depth", [
    ((32, 32), 2, 8),
    ((67, 93), 3, 8),        # odd sizes: ceil/floor subband splits
    ((64, 1), 2, 8),         # zero-size HL/HH subbands
    ((48, 40), 3, 16),
    ((40, 56, 3), 2, 16),
])
def test_lossless_jax_encoder_exact(shape, levels, depth):
    img = _img(sum(shape) + depth, shape, depth)
    data = j_encoder.encode_jp2(img, depth, EncodeParams(
        lossless=True, levels=levels))
    _lossless_equal(data, img)


def test_lossless_port_encoder_gray_exact():
    """A file the port itself writes (on the CPU) reads back exactly, as
    through the JAX decoder."""
    img = _quiet(5, (40, 48))
    data = t_encoder.encode_jp2(img, 8, t_encoder.EncodeParams(
        lossless=True, levels=2), device="cpu")
    _lossless_equal(data, img)


def test_straddling_tile_grid_exact():
    """Tile size 96 at 2 levels (JAX encoder): sub-bands straddle global
    64-grid cells, so code-blocks are clipped to them."""
    img = _img(11, (96, 96, 3))
    data = j_encoder.encode_jp2(img, 8, EncodeParams(
        lossless=True, levels=2, tile_size=96))
    _lossless_equal(data, img)


@pytest.mark.parametrize("prog", [0, 1, 2, 3, 4])   # LRCP..CPRL
def test_all_progressions_exact(prog):
    img = _img(20 + prog, (64, 48, 3))
    data = j_encoder.encode_jp2(img, 8, EncodeParams(
        lossless=True, levels=2, progression=prog, n_layers=2,
        precincts=((128, 128),)))
    _lossless_equal(data, img)
    # Partial reads walk each progression's early stop differently.
    _lossless_equal(data, None, reduce=1)
    _lossless_equal(data, None, layers=1)


def test_kakadu_recipe_reduce_and_layers_exact(port_file):
    """The port's own file with the reference recipe across a tile grid:
    every reduce 0..levels and layer caps equal the JAX decoder, and the
    full read equals the source."""
    img, data = port_file
    assert b"\xff\x91" in data and b"\xff\x92" in data
    _lossless_equal(data, img)
    for r in (1, 2, 3):
        got = _lossless_equal(data, None, reduce=r)
        assert got.shape == (-(-72 // (1 << r)), -(-40 // (1 << r)), 3)
    _lossless_equal(data, None, layers=2)
    _lossless_equal(data, None, reduce=1, layers=3)


def test_raw_codestream_and_boxing_and_probe():
    img = _img(41, (32, 40), 16)
    params = EncodeParams(lossless=True, levels=3)
    raw = j_encoder.encode_array(img, 16, params)
    jpx = j_encoder.encode_jp2(img, 16, params, jpx=True)
    jp2 = j_encoder.encode_jp2(img, 16, params)
    for data in (raw, jpx, jp2):
        assert decode(data, device="cpu").dtype == np.uint16
        _lossless_equal(data, img)
        assert probe(data) == j_probe(data)
    info = probe(jp2)
    assert (info["width"], info["height"], info["bitdepth"]) == (40, 32, 16)


def test_reduce_and_layers_are_validated():
    img = _img(43, (40, 36))
    data = j_encoder.encode_jp2(img, 8, EncodeParams(lossless=True,
                                                     levels=3))
    with pytest.raises(InvalidParam):
        decode(data, reduce=4, device="cpu")       # beyond the levels
    with pytest.raises(InvalidParam):
        decode(data, reduce=-1, device="cpu")
    with pytest.raises(InvalidParam):
        decode(data, layers=0, device="cpu")
    assert issubclass(InvalidParam, DecodeError)


def _tier1_planes(parser, decoder, data, reduce=0):
    ps = parser.parse(data, reduce=reduce)
    return [decoder._tile_hvals(ps, tile, reduce)[:3] for tile in ps.tiles]


@pytest.fixture(scope="module")
def lossy_file():
    img = _smooth(47, 80, 72)
    return img, j_encoder.encode_jp2(img, 8, EncodeParams(
        lossless=False, levels=3, tile_size=64, mct="on"))


@pytest.mark.parametrize("reduce", [0, 2])
def test_lossy_tier1_identical_and_samples_within_one(lossy_file, reduce):
    """9/7 + ICT: the Tier-1 half-magnitudes are identical, and the
    samples (float synthesis, rounded) are within +-1 of JAX's."""
    img, data = lossy_file
    got_t1 = _tier1_planes(t_parser, t_decoder, data, reduce)
    ref_t1 = _tier1_planes(j_parser, j_decoder, data, reduce)
    assert len(got_t1) == len(ref_t1) == 4
    for (gp, gb, gd), (rp, rb, rd) in zip(got_t1, ref_t1):
        np.testing.assert_array_equal(gp, rp)
        assert (gb, gd) == (rb, rd)
    got = decode(data, reduce=reduce, device="cpu").astype(np.int64)
    ref = j_decode(data, reduce=reduce).astype(np.int64)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 1, f"{int((diff > 0).sum())} samples differ"
    if reduce == 0:
        mse = np.mean((got - img.astype(np.int64)) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) > 40.0


def test_lossy_layers_within_one():
    img = _smooth(53, 64, 64, comps=1)
    data = j_encoder.encode_jp2(img, 8, EncodeParams(
        lossless=False, levels=3, n_layers=4, rate=2.0, base_delta=0.5))
    for layers in (1, 3):
        got = decode(data, layers=layers, device="cpu").astype(np.int64)
        ref = j_decode(data, layers=layers).astype(np.int64)
        assert np.abs(got - ref).max() <= 1


def test_metrics_equal_jax(port_file):
    """The stage names of the sink contract, and the same Tier-1 volume
    (blocks, MQ decisions, packets skipped) as the JAX decoder."""
    _, data = port_file
    reports = []
    for setter, run in ((set_metrics_sink,
                         lambda: decode(data, reduce=1, device="cpu")),
                        (j_decoder.set_metrics_sink,
                         lambda: j_decode(data, reduce=1))):
        sink = Metrics()
        setter(sink)
        try:
            run()
        finally:
            setter(None)
        reports.append(sink.report())
    got, ref = reports
    for stage in ("decode.t2_parse", "decode.mq", "decode.t1",
                  "decode.device_inverse"):
        assert stage in got["stages"], stage
        assert got["stages"][stage].get("items") == \
            ref["stages"][stage].get("items"), stage
    for name in ("decode.blocks", "decode.mq_symbols",
                 "decode.packets_skipped"):
        assert got["counters"][name] == ref["counters"][name] > 0, name


@pytest.mark.parametrize("seed", [0, 1])
def test_mq_decoder_equal(seed):
    """The port's MQDecoder reads the port's MQEncoder output back and
    steps as the JAX decoder does, decision for decision."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, 19, 4000)
    bits = (rng.random(4000) < 0.2).astype(int)
    enc = t_mq.MQEncoder()
    for b, c in zip(bits, ctx):
        enc.encode(int(b), int(c))
    data = enc.flush()
    a, b = t_mq.MQDecoder(data), j_mq.MQDecoder(data)
    got = [a.decode(int(c)) for c in ctx]
    ref = [b.decode(int(c)) for c in ctx]
    assert got == ref == bits.tolist()


# --- malformed input -----------------------------------------------------

@pytest.fixture(scope="module")
def valid_stream():
    img = _img(99, (48, 40))
    return img, j_encoder.encode_jp2(img, 8, EncodeParams(lossless=True,
                                                          levels=2))


def _outcome(fn, data, error):
    try:
        return fn(data)
    except error:
        return None


@pytest.mark.parametrize("kind", ["truncate", "flip"])
def test_damaged_streams_match_jax(valid_stream, kind):
    """A dozen seeded damages of each kind: the port raises DecodeError
    exactly where the JAX decoder does (never IndexError/struct.error),
    and decodes the same pixels where it does not; every truncation
    raises."""
    _, data = valid_stream
    rng = np.random.default_rng(7 if kind == "truncate" else 11)
    for _ in range(12):
        if kind == "truncate":
            mutated = data[:int(rng.integers(0, len(data) - 1))]
        else:
            mutated = bytearray(data)
            mutated[int(rng.integers(0, len(data)))] ^= \
                1 << int(rng.integers(0, 8))
            mutated = bytes(mutated)
        got = _outcome(lambda d: decode(d, device="cpu"), mutated,
                       DecodeError)
        ref = _outcome(j_decode, mutated, JDecodeError)
        assert (got is None) == (ref is None)
        if got is not None:
            np.testing.assert_array_equal(got, ref)
        if kind == "truncate":
            assert got is None


def test_garbage_and_unsupported_are_typed(valid_stream):
    for junk in (b"", b"\x00", b"not a jp2 at all", b"\xff" * 64,
                 bytes(range(256)), t_parser._JP2_SIG,
                 t_parser._JP2_SIG + b"\x00\x00\x00\x99ftyp"):
        with pytest.raises(DecodeError):
            decode(junk, device="cpu")
    with pytest.raises(TypeError):
        decode(12345, device="cpu")
    _, data = valid_stream
    siz = data.find(struct.pack(">H", 0xFF51))
    huge = bytearray(data)
    struct.pack_into(">I", huge, siz + 6, 0x7FFFFFFF)   # Xsiz
    with pytest.raises(DecodeError):
        decode(bytes(huge), device="cpu")
    cod = data.find(struct.pack(">H", 0xFF52))
    wavelet = bytearray(data)
    wavelet[cod + 13] = 7                               # unknown transform
    with pytest.raises(DecodeError):
        decode(bytes(wavelet), device="cpu")


def test_card_without_cuda_raises(valid_stream, monkeypatch):
    """decode() defaults to the card and never carries on on the CPU in
    its place."""
    _, data = valid_stream
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        decode(data)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        decode(data, region=(0, 0, 8, 8), device="cuda")
