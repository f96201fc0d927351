"""Deep-colour TIFF sources on the CPU: the port's own reader
(converters/tiff_source.py) against the written samples and against
PIL's ``tiff.read_image`` where PIL is exact, the files it refuses, the
converter's choice of reader with its ``convert.read`` span, the
Tier-1 assembly's pass counts, and 16-bit RGB encodes with partial
tiles held byte for byte to the JAX package's."""
import dataclasses
import struct
import textwrap

import numpy as np
import pytest

from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu_torch import obs
from bucketeer_tpu_torch.analysis import lint
from bucketeer_tpu_torch.codec import cxd, tiff
from bucketeer_tpu_torch.codec import encoder as t_encoder
from bucketeer_tpu_torch.codec.decode import decode
from bucketeer_tpu_torch.converters import (Conversion, ConverterError,
                                            CudaConverter, cuda,
                                            tiff_source)
from bucketeer_tpu_torch.obs.trace import Recorder
from bucketeer_tpu_torch.server.metrics import Metrics

# Field types: SHORT, LONG, LONG8.
_SHORT, _LONG, _LONG8 = 3, 4, 16


def _image(h, w, spp, bits, seed=1):
    top = (1 << bits) - 1
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (0.45 + 0.3 * np.sin(x / 7.0) * np.cos(y / 5.0)) * top
    img = base[..., None] + rng.normal(0, top * 0.04, (h, w, spp))
    return np.clip(img, 0, top).astype(np.uint16 if bits > 8 else np.uint8)


def write_tiff(path, img, order="<", rows_per_strip=None, planar=1,
               extra=(), compression=1, tiled=False, big=False,
               sample_format=None, photometric=None, rps_tag=None):
    """A TIFF of ``img`` (h, w, spp): either byte order, strips of
    ``rows_per_strip`` rows, chunky or planar, classic or BigTIFF, with
    the tags given (the pixel data stays raw whatever ``compression``
    says)."""
    h, w, spp = img.shape
    bits = img.dtype.itemsize * 8
    rps = rows_per_strip or h
    data = img.astype(img.dtype.newbyteorder(order))
    planes = [data[:, :, k] for k in range(spp)] if planar == 2 else [data]
    strips = [np.ascontiguousarray(p[r:r + rps]).tobytes()
              for p in planes for r in range(0, h, rps)]
    off_fmt = "Q" if big else "I"
    blob = bytearray(b"II" if order == "<" else b"MM")
    blob += (struct.pack(order + "HHHQ", 43, 8, 0, 0) if big
             else struct.pack(order + "HI", 42, 0))
    offsets = []
    for s in strips:
        offsets.append(len(blob))
        blob += s
    tags = {256: (_LONG, [w]), 257: (_LONG, [h]),
            258: (_SHORT, [bits] * spp), 259: (_SHORT, [compression]),
            262: (_SHORT, [photometric if photometric is not None
                           else (1 if spp == 1 else 2)]),
            277: (_SHORT, [spp]), 284: (_SHORT, [planar])}
    big_type = _LONG8 if big else _LONG
    if tiled:
        tags.update({322: (_LONG, [w]), 323: (_LONG, [h]),
                     324: (big_type, offsets[:1]),
                     325: (big_type, [len(strips[0])])})
    else:
        tags.update({273: (big_type, offsets),
                     278: (_LONG, [rps if rps_tag is None else rps_tag]),
                     279: (big_type, [len(s) for s in strips])})
    if extra:
        tags[338] = (_SHORT, list(extra))
    if sample_format is not None:
        tags[339] = (_SHORT, [sample_format] * spp)
    inline = 8 if big else 4
    codes = {_SHORT: "H", _LONG: "I", _LONG8: "Q"}
    entries = []
    for tag in sorted(tags):
        typ, vals = tags[tag]
        field = struct.pack(f"{order}{len(vals)}{codes[typ]}", *vals)
        if len(field) > inline:
            at = len(blob)
            blob += field
            field = struct.pack(order + off_fmt, at)
        entries.append(struct.pack(order + "HH" + off_fmt, tag, typ,
                                   len(vals)) + field.ljust(inline, b"\0"))
    ifd = len(blob)
    blob += struct.pack(order + ("Q" if big else "H"), len(entries))
    blob += b"".join(entries) + struct.pack(order + off_fmt, 0)
    struct.pack_into(order + off_fmt, blob, 8 if big else 4, ifd)
    with open(path, "wb") as fh:
        fh.write(blob)
    return str(path)


KINDS = {"rgb16": (3, ()), "rgba16": (4, (2,)), "gray16": (1, ())}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("planar", [1, 2], ids=["chunky", "planar"])
@pytest.mark.parametrize("rps", [None, 5], ids=["one_strip", "strips"])
@pytest.mark.parametrize("order,big", [("<", False), (">", False),
                                       ("<", True)],
                         ids=["II", "MM", "II-bigtiff"])
def test_reader_returns_every_sample(tmp_path, kind, planar, rps, order,
                                     big):
    """17x13 images (strips of 5 rows leave a short last strip): every
    sample back, the alpha sample dropped, gray as (H, W); the converter
    routes all but little-endian gray (PIL's exact case) to the reader.
    (PIL parses no big-endian BigTIFF: see the refusals below.)"""
    spp, extra = KINDS[kind]
    img = _image(17, 13, spp, 16)
    path = write_tiff(tmp_path / "s.tif", img, order, rps, planar, extra,
                      big=big)
    got, depth = tiff_source.read_image(path)
    want = img[:, :, :3] if spp == 4 else img
    assert depth == 16 and got.dtype == np.uint16
    assert np.array_equal(got, want.reshape(17, 13) if spp == 1 else want)
    assert tiff_source.deep(path) == (spp >= 3 or order == ">")


@pytest.mark.parametrize("rps", [None, 5], ids=["one_strip", "strips"])
def test_reader_agrees_with_pil_where_pil_is_exact(tmp_path, rps):
    """Little-endian 16-bit gray, the one deep layout PIL reads exactly."""
    path = write_tiff(tmp_path / "s.tif", _image(21, 11, 1, 16), "<", rps)
    got, depth = tiff_source.read_image(path)
    ref, ref_depth = tiff.read_image(path)
    assert depth == ref_depth == 16
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("spp,order", [(3, "<"), (3, ">"), (1, ">")],
                         ids=["rgb16-II", "rgb16-MM", "gray16-MM"])
def test_pil_truncates_what_the_reader_keeps(tmp_path, spp, order):
    """The faults the reader exists for: PIL hands a 48-bit RGB TIFF back
    as its high bytes, and big-endian 16-bit gray clipped to 255."""
    img = _image(9, 8, spp, 16)
    path = write_tiff(tmp_path / "s.tif", img, order)
    pil, depth = tiff.read_image(path)
    assert depth == 8
    if spp == 3:
        assert np.array_equal(pil, (img >> 8).astype(np.uint8))
    else:
        assert int(pil.max()) == 255 < int(img.max())
    back = tiff_source.read_image(path)[0]
    assert np.array_equal(back, img.reshape(9, 8) if spp == 1 else img)


@pytest.mark.parametrize("kw,why", [
    ({"compression": 5}, "LZW"), ({"compression": 8}, "Deflate"),
    ({"compression": 32773}, "PackBits"), ({"tiled": True}, "tiled"),
    ({"rps_tag": 0}, "no rows per strip"),
    ({"order": ">", "spp": 1, "sample_format": 2}, "unsigned"),
])
def test_undecodable_deep_source_is_refused(tmp_path, kw, why):
    kw = dict(kw)
    img = _image(8, 8, kw.pop("spp", 3), 16)
    path = write_tiff(tmp_path / "s.tif", img, **kw)
    assert tiff_source.deep(path)
    with pytest.raises(ConverterError, match=why):
        tiff_source.read_image(path)


@pytest.mark.parametrize("kw", [
    {"photometric": 5}, {"order": ">", "big": True},
    {"order": ">", "spp": 1, "photometric": 0}, {"order": ">", "spp": 2},
], ids=["rgb16-separated", "rgb16-MM-bigtiff", "gray16-MM-white-is-zero",
        "gray-alpha16-MM"])
def test_a_deep_source_pil_cannot_open_is_refused(tmp_path, monkeypatch,
                                                  kw):
    """Where PIL parses no tags the file is not taken as deep, and the
    converter refuses it through PIL's own error: never 8-bit samples."""
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    kw = dict(kw)
    img = _image(8, 8, kw.pop("spp", 3), 16)
    path = write_tiff(tmp_path / "s.tif", img, **kw)
    assert not tiff_source.deep(path)
    with pytest.raises(ConverterError, match="cannot read"):
        CudaConverter(device="cpu").convert("x", path)


def test_an_8bit_source_is_not_deep_and_refused(tmp_path):
    path = write_tiff(tmp_path / "s.tif", _image(8, 8, 3, 8), ">")
    assert not tiff_source.deep(path)
    with pytest.raises(ConverterError, match="8, 8, 8. bits per sample"):
        tiff_source.read_image(path)


def test_a_short_strip_is_refused(tmp_path):
    path = write_tiff(tmp_path / "s.tif", _image(8, 8, 3, 16))
    n = 8 * 8 * 3 * 2
    with open(path, "r+b") as fh:     # StripByteCounts one byte short
        blob = bytearray(fh.read())
        at = blob.index(struct.pack("<HHII", 279, _LONG, 1, n))
        struct.pack_into("<I", blob, at + 8, n - 1)
        fh.seek(0)
        fh.write(blob)
    with pytest.raises(ConverterError, match="strip 0 holds"):
        tiff_source.read_image(path)


def test_reader_honours_the_pixel_ceiling(tmp_path, monkeypatch):
    path = write_tiff(tmp_path / "s.tif", _image(8, 8, 3, 16))
    monkeypatch.setenv("BUCKETEER_MAX_IMAGE_PIXELS", "63")
    assert not tiff_source.deep(path)     # left to tiff.read_image
    for read in (tiff_source.read_image, tiff.read_image):
        with pytest.raises(ValueError, match="63-pixel ceiling"):
            read(path)


def test_what_is_no_tiff(tmp_path):
    from PIL import Image
    png = tmp_path / "s.png"
    Image.fromarray(_image(8, 8, 3, 8)).save(png)
    assert tiff_source.tags(str(png)) is None
    with pytest.raises(ConverterError, match="not a TIFF"):
        tiff_source.read_image(str(png))
    (tmp_path / "empty.tif").write_bytes(b"")
    for path in (png, tmp_path / "empty.tif"):
        assert not tiff_source.deep(str(path))


@pytest.fixture
def recorder():
    prev = obs.get_recorder()
    rec = Recorder()
    obs.install(rec)
    try:
        yield rec
    finally:
        obs.install(prev)


@pytest.mark.parametrize("spp", [3, 1], ids=["rgb16", "gray16"])
def test_converter_lands_every_deep_sample(tmp_path, monkeypatch,
                                           recorder, spp):
    """A 24x20 16-bit big-endian TIFF (RGB planar, or gray) converts on
    the CPU to a file whose decode is the source; the read span names the
    deep reader."""
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    img = _image(24, 20, spp, 16, seed=3)
    src = write_tiff(tmp_path / "s.tif", img, ">", 7,
                     2 if spp == 3 else 1)
    with obs.request_context("deep-1"):
        out = CudaConverter(device="cpu").convert("ark:/1/d", src,
                                                  Conversion.LOSSLESS)
    with open(out, "rb") as fh:
        back = np.asarray(decode(fh.read(), device="cpu"))
    assert back.dtype == np.uint16
    assert np.array_equal(back.reshape(img.shape), img)
    (read,) = [s for s in recorder.spans_for("deep-1")
               if s["name"] == "convert.read"]
    assert read["attrs"] == {"reader": "deep", "bitdepth": 16,
                             "components": spp, "bytes": img.nbytes}


def test_converter_reads_other_sources_through_pil(tmp_path, monkeypatch,
                                                   recorder):
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    calls = []
    real = cuda.tiff.read_image
    monkeypatch.setattr(cuda.tiff, "read_image",
                        lambda p: calls.append(p) or real(p))
    for name, img in (("g16.tif", _image(16, 16, 1, 16)),
                      ("rgb8.tif", _image(16, 16, 3, 8))):
        src = write_tiff(tmp_path / name, img)
        with obs.request_context(name):
            CudaConverter(device="cpu").convert(name, src)
        (read,) = [s for s in recorder.spans_for(name)
                   if s["name"] == "convert.read"]
        assert read["attrs"]["reader"] == "pil"
    assert len(calls) == 2


def test_converter_never_truncates_an_undecodable_deep_source(
        tmp_path, monkeypatch):
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    monkeypatch.setattr(cuda.tiff, "read_image",
                        lambda p: pytest.fail("PIL read a deep source"))
    src = write_tiff(tmp_path / "s.tif", _image(8, 8, 3, 16),
                     compression=5)
    with pytest.raises(ConverterError, match="compressed .LZW."):
        CudaConverter(device="cpu").convert("x", src)
    src = write_tiff(tmp_path / "g.tif", _image(8, 8, 1, 16), ">",
                     compression=5)
    with pytest.raises(ConverterError, match="compressed .LZW."):
        CudaConverter(device="cpu").convert("y", src)


def test_async_lint_flags_the_deep_read(tmp_path):
    """The deep reader is one more blocking read for the async rule
    (its leaf is ``read_image``, as PIL's is)."""
    root = tmp_path / "pkg"
    (root / "engine").mkdir(parents=True)
    for d in (root, root / "engine"):
        (d / "__init__.py").write_text('"""fixture"""\n')
    (root / "engine" / "bad.py").write_text(textwrap.dedent("""\
        from ..converters import tiff_source


        async def handle(path):
            return tiff_source.read_image(path)
        """))
    assert [f.rule for f in lint.run_lint(root)] == \
        ["blocking-call-in-async"]


# --- 16-bit RGB encodes with partial tiles, against the JAX package ----

def _kakadu(**over):
    j = dataclasses.replace(
        j_encoder.EncodeParams.kakadu_recipe(lossless=True), **over)
    t = dataclasses.replace(
        t_encoder.EncodeParams.kakadu_recipe(lossless=True), **over)
    return j, t


def test_rgb16_host_coder_equals_jax_with_partial_tiles():
    """600x520 at the recipe's 512 tiles: four tile shapes (512x512,
    512x8, 88x512, 88x8), the host Tier-1."""
    img = _image(600, 520, 3, 16, seed=5)
    jp, tp = _kakadu()
    got = t_encoder.encode_jp2(img, 16, tp, device="cpu")
    assert got == j_encoder.encode_jp2(img, 16, jp)


def test_rgb16_fused_path_equals_jax_with_partial_tiles(recorder):
    """40x36 at 32x32 tiles, 3 levels, the fused Tier-1's plain version
    (L=16 groups): the JAX package's bytes; the assembly spans carry
    their group's L and pass count, whose sum is the sink's
    ``encode.t1_passes`` and the passes of the assembled blocks."""
    img = _image(40, 36, 3, 16, seed=6)
    jp, tp = _kakadu(levels=3, tile_size=32)
    tp.device_mq = True
    assembled = []
    real = cxd.assemble_group_columns

    def counting(cols, src, idxs, eff, *a):
        real(cols, src, idxs, eff, *a)
        assembled.append(int(np.diff(cols.pass_off)[idxs].sum()))

    sink = Metrics()
    t_encoder.set_metrics_sink(sink)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cxd, "assemble_group_columns", counting)
            with obs.request_context("fused-16"):
                got = t_encoder.encode_jp2(img, 16, tp, device="cpu")
    finally:
        t_encoder.set_metrics_sink(None)
    assert got == j_encoder.encode_jp2(img, 16, jp)
    spans = [s for s in recorder.spans_for("fused-16")
             if s["name"] == "encode.t1_assemble"]
    assert [s["attrs"]["passes"] for s in spans] == assembled
    assert 16 in {s["attrs"]["L"] for s in spans}
    assert sink.report()["counters"]["encode.t1_passes"] == \
        sum(assembled) > 0
