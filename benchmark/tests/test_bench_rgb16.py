"""The 16-bit RGB cell on the CPU: its sources read back at full depth
through the converter's read, a small copy of the cell (partial tiles)
runs correct, and the same run with the deep read put back to PIL's
8-bit read comes out not correct."""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

from benchmark.harness import images
from benchmark.tests.conftest import run_small

CELL = "ingest-lossless-rgb16"
CONFIG = "kdu-lossless-rgb16-6000x4800"


def test_rgb16_sources_round_trip_through_the_converters_read(tmp_path):
    from bucketeer_tpu_torch.converters import cuda
    img = images.scan(2**33 + 7, 0, 40, 56, "cpu", 3, 16)
    assert img.dtype == np.uint16 and int(img.max()) > 1 << 14
    path = str(tmp_path / "s.tif")
    images.write_tiff(path, img)
    assert cuda.tiff_source.deep(path)
    back, depth = cuda.tiff_source.read_image(path)
    assert depth == 16 and np.array_equal(back, img)


@pytest.fixture
def rgb16_bench(small_bench, tmp_path):
    """The small copy with the cell's images 544x200: a 512-row tile and
    a 32-row one, so the file has partial tiles as the 6000x4800 one
    does."""
    root = tmp_path / "b"
    shutil.copytree(small_bench, root)
    path = root / "configs" / f"{CONFIG}.json"
    c = json.loads(path.read_text())
    c.update(image_rows=544, image_columns=200)
    path.write_text(json.dumps(c))
    mix = root / "traffic" / "single-closed-4src.json"
    m = json.loads(mix.read_text())
    m.update(sources=2, check={"objects": 1, "blocks": 8})
    mix.write_text(json.dumps(m))
    return str(root)


def test_small_rgb16_cell_is_correct(rgb16_bench):
    kinds = []
    rc, res, err = run_small(rgb16_bench, CELL, faults=kinds.append)
    assert rc == 0 and res["correct"], err
    assert res["checks"]["mismatch"]["value"] == 0
    assert kinds[0].sources[0][1].dtype == np.uint16
    assert "encode_mpix_s" in res["metrics"]


def test_pils_8bit_read_in_the_deep_reads_place_is_not_correct(
        rgb16_bench, monkeypatch):
    from bucketeer_tpu_torch.converters import cuda
    monkeypatch.setattr(cuda.tiff_source, "read_image", cuda.tiff.read_image)
    rc, res, err = run_small(rgb16_bench, CELL)
    assert rc == 0, err
    assert res["correct"] is False, err
    assert res["checks"]["mismatch"]["value"] > 0
