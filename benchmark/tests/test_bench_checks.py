"""What decides ``correct``, on the CPU at small sizes: the reference
passes the port's files, its control fails them, and a run with the
timed path broken underneath comes out not correct, once for each fault
a cell can have (an answer altered where it is produced, half of the
work left out, the exchange between cards left out)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import images, spec
from benchmark.reference import judge, wavelet
from benchmark.tests import faults
from benchmark.tests.conftest import run_small, sized

SEED = 2**31 + 99


def _encode(img, lossless):
    from bucketeer_tpu_torch.codec import encoder
    params = encoder.EncodeParams.kakadu_recipe(lossless=lossless, rate=3.0)
    return encoder.encode_jp2(img, 8, params, jpx=True, device="cpu")


@pytest.mark.parametrize("lossless", [True, False])
def test_reference_passes_the_port_and_its_control_fails(lossless):
    """A 1024x1024 file of 4 tiles, one whole tile and 24 blocks drawn:
    the port's file reads as the configuration's limits allow; the
    control, put in its place, fails them."""
    img = images.scan(SEED, 0, 1024, 1024, "cpu")
    data = _encode(img, lossless)
    name = "kdu-lossless-rgb8-4096" if lossless else "kdu-lossy-rgb8-2048"
    config = spec.config(name)
    lim = config["limits"]
    res = judge.combine([judge.judge_file(
        data, judge.Truth(img), np.random.default_rng(3), 24,
        config["quant_base_step"], control=True)])
    assert res["blocks"] == res["control.blocks"] >= 3 * 73 + 12
    if lossless:
        assert res["mismatch"] == 0 <= lim["mismatch"]
        assert res["control.mismatch"] > 1000
    else:
        assert res["gap"] <= lim["gap"] / 100
        assert res["distortion"] < lim["distortion"]
        assert res["control.gap"] > 10 * lim["gap"]


def test_half_the_tiles_empty_reads_far_over_the_limits(monkeypatch):
    """A lossy file whose every other tile has empty packets: its
    midpoints read far from the reference, though the encoder's size
    loop brings it close to its rate."""
    img = images.scan(SEED, 0, 1024, 1024, "cpu")
    lim = spec.config("kdu-lossy-rgb8-2048")["limits"]
    faults.half_tiles_empty(monkeypatch.setattr)
    data = _encode(img, False)
    res = judge.combine([judge.judge_file(
        data, judge.Truth(img), np.random.default_rng(3), 24, 2.0)])
    assert res["distortion"] > 10 * lim["distortion"]


def test_read_reference_and_its_control():
    img = images.scan(SEED, 1, 256, 256, "cpu")
    full = judge.read_truth(img, 128, 0, None, True)
    assert np.array_equal(full, img)
    part = judge.read_truth(img, 128, 0, (64, 128, 64, 64), True)
    assert np.array_equal(part, img[128:192, 64:128])
    small = judge.read_truth(img, 128, 2, None, True)
    assert small.shape == (64, 64, 3)
    assert np.count_nonzero(judge.read_truth(img, 128, 2, None, True,
                                             bit_short=True) != small) > 100


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.14159], np.float32)
    assert wavelet.bf16(x).tolist() == [1.0, 1.0, 1.0078125, 3.140625]


def _sound(small_bench, cell, **kw):
    rc, res, err = run_small(small_bench, cell, **kw)
    assert rc == 0 and res["correct"], err
    return res


def _broken(small_bench, cell, **kw):
    rc, res, err = run_small(small_bench, cell, **kw)
    assert rc == 0, err
    assert res["correct"] is False, err
    return res


@pytest.mark.parametrize("cell", ["ingest-lossless-4k", "csv-lossy-2k",
                                  "iiif-lossless-4k"])
def test_control_in_the_programs_place_is_not_correct(small_bench, cell):
    """One run reads the program and the control by the same comparison:
    the program's verdict is correct, the control's is not."""
    rc, res, err = run_small(small_bench, cell, control=1)
    assert rc == 0 and res["correct"], err
    assert "control correct False" in err.splitlines(), err


@pytest.mark.parametrize("cell", ["ingest-lossless-4k", "csv-lossy-2k"])
def test_altered_answer_is_not_correct(small_bench, cell, monkeypatch):
    _sound(small_bench, cell)
    faults.lsb_flipped(monkeypatch.setattr)
    res = _broken(small_bench, cell)
    key = "mismatch" if cell.startswith("ingest") else "gap"
    assert res["checks"][key]["value"] > res["checks"][key]["limit"]


@pytest.mark.parametrize("cell,key", [("ingest-lossless-4k", "missing"),
                                      ("csv-lossy-2k", "unresolved")])
def test_half_the_work_left_out_is_not_correct(small_bench, cell, key):
    res = _broken(small_bench, cell, seconds=2.0,
                  faults=faults.half_uploads_dropped)
    assert res["checks"][key]["value"] >= 1


@pytest.mark.parametrize("cell,key", [("ingest-lossless-4k", "mismatch"),
                                      ("csv-lossy-2k", "distortion")])
def test_empty_packets_for_half_the_tiles_is_not_correct(small_bench, cell,
                                                         key, monkeypatch):
    """Files of four tiles, every other tile coded with no pass."""
    with sized(small_bench, cell, 1024, items_per_job=2, warm_items=1,
               sources=1):
        _sound(small_bench, cell)
        faults.half_tiles_empty(monkeypatch.setattr)
        res = _broken(small_bench, cell)
    assert res["checks"][key]["value"] > res["checks"][key]["limit"]


@pytest.mark.parametrize("change", [
    lambda a: (a.astype(np.int16) + 1).clip(0, 255).astype(a.dtype),
    lambda a: a[: a.shape[0] // 2]], ids=["altered", "half"])
def test_broken_reads_are_not_correct(small_bench, change):
    _sound(small_bench, "iiif-lossless-4k")
    res = _broken(small_bench, "iiif-lossless-4k",
                  faults=faults.reads_changed(change))
    assert res["checks"]["mismatch"]["value"] > 0


@pytest.fixture
def two_card_mesh(small_bench, monkeypatch):
    """The map cell at 1024x1024 (four 512 tiles) routed over a data mesh
    of two CPU entries, as the card's converter routes it over four."""
    from bucketeer_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * 2)
    with sized(small_bench, "map-lossless-8k-mesh4", 1024):
        yield small_bench


def _route_over_mesh(kind):
    kind.engine.converter.mesh_min_pixels = 1


def test_exchange_between_cards_left_out_is_not_correct(two_card_mesh,
                                                        monkeypatch):
    routed = []
    from bucketeer_tpu_torch.parallel import batch
    real = batch.run_tiles_sharded
    monkeypatch.setattr(batch, "run_tiles_sharded",
                        lambda *a: routed.append(1) or real(*a))
    _sound(two_card_mesh, "map-lossless-8k-mesh4", faults=_route_over_mesh)
    assert routed
    faults.second_shard_zeroed(monkeypatch.setattr)
    res = _broken(two_card_mesh, "map-lossless-8k-mesh4",
                  faults=_route_over_mesh)
    assert res["checks"]["mismatch"]["value"] > 0
