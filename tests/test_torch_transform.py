"""Sample transform and Tier-1 front-end: the port on the CPU against
the JAX package's jitted programs on the CPU, same numpy inputs."""
import dataclasses

import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import frontend as j_frontend
from bucketeer_tpu.codec import pipeline as j_pipeline
from bucketeer_tpu_torch.codec import frontend as t_frontend
from bucketeer_tpu_torch.codec import pipeline as t_pipeline


def _batch(seed, b, h, w, c, bitdepth=8):
    rng = np.random.default_rng(seed)
    dt = np.uint16 if bitdepth > 8 else np.uint8
    shape = (b, h, w, c) if c > 1 else (b, h, w)
    tiles = rng.integers(0, 1 << bitdepth, shape).astype(dt)
    return tiles if c > 1 else tiles[..., None]


def _both(plan_args, tiles):
    jp = j_pipeline.make_plan(*plan_args)
    tp = t_pipeline.make_plan(*plan_args)
    ref = np.asarray(j_pipeline.compiled_transform(jp)(tiles))
    step = None if tp.lossless else torch.as_tensor(
        t_pipeline._step_map(tp))
    got = t_pipeline._transform_batch(tp, step,
                                      torch.as_tensor(tiles.astype(
                                          np.int32))).numpy()
    return ref, got


@pytest.mark.parametrize("h,w,c,levels", [
    (64, 64, 1, 5), (48, 40, 3, 4), (1, 8, 1, 2), (8, 1, 1, 2),
    (7, 5, 3, 3), (2, 3, 1, 1), (33, 17, 3, 6), (5, 8, 1, 3)])
def test_lossless_transform_identical(h, w, c, levels):
    """5/3 + RCT integer output is identical, including axes of 1-8
    samples where the symmetric extension reflects more than once."""
    ref, got = _both((h, w, c, levels, True, 8, 1.0, c == 3),
                     _batch(h * w + levels, 2, h, w, c))
    np.testing.assert_array_equal(got, ref)


def test_lossless_transform_16bit_identical():
    ref, got = _both((40, 24, 1, 3, True, 16, 1.0, None),
                     _batch(7, 1, 40, 24, 1, bitdepth=16))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h,w,c,levels", [(64, 64, 3, 5), (96, 64, 1, 3),
                                          (37, 29, 3, 6)])
def test_lossy_indices_within_one(h, w, c, levels):
    """9/7 + ICT quantizer indices: |delta| <= 1 on at most 0.1% of
    samples — float32 op order differs (XLA may fuse and contract what
    the port runs as separate elementwise ops)."""
    ref, got = _both((h, w, c, levels, False, 8, 0.5, c == 3),
                     _batch(h + w, 2, h, w, c))
    ri = np.abs(ref.astype(np.int64)) >> 7
    gi = np.abs(got.astype(np.int64)) >> 7
    d = np.abs(ri - gi)
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3
    np.testing.assert_array_equal(np.sign(ref[ri > 1]), np.sign(got[ri > 1]))


@pytest.mark.parametrize("lossless,c", [(True, 1), (True, 3), (False, 3)])
def test_frontend_mq_outputs(lossless, c):
    """Mode "mq" front-end: blocks / maxidx / newsig identical (lossless;
    lossy within the transform's index tolerance), sigd / refd within
    rtol 1e-5 — float32 reductions summed in another order."""
    h = w = 96
    args = (h, w, c, 3, lossless, 8, 0.5, c == 3)
    tiles = _batch(11 + c, 2, h, w, c)
    jp = j_pipeline.make_plan(*args)
    tp = t_pipeline.make_plan(*args)
    pend = j_frontend.dispatch_frontend(jp, tiles, mode="mq")
    jres = pend.resolve_stats()
    tres = t_frontend.dispatch_frontend(tp, tiles,
                                        device="cpu").resolve_stats()
    astuple = dataclasses.astuple
    assert [astuple(m) for m in t_frontend.layout_for(tp).metas] == \
        [astuple(m) for m in j_frontend.layout_for(jp).metas]
    assert t_frontend.layout_for(tp).P == j_frontend.layout_for(jp).P
    jb = np.asarray(jres.blocks)
    tb = tres.blocks.numpy()
    if lossless:
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tres.nbps, jres.nbps)
        np.testing.assert_array_equal(tres.newsig, jres.newsig)
        np.testing.assert_allclose(tres.sigd, jres.sigd, rtol=1e-5)
        np.testing.assert_allclose(tres.refd, jres.refd, rtol=1e-5)
    else:
        d = np.abs((np.abs(tb.astype(np.int64)) >> 7)
                   - (np.abs(jb.astype(np.int64)) >> 7))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        assert np.abs(tres.nbps - jres.nbps).max() <= 1
        # Stats of the port's own blocks equal a numpy recomputation.
        idx = np.abs(tb.astype(np.int64)) >> 7
        np.testing.assert_array_equal(
            tres.newsig[:, 0],
            ((idx != 0) & ((idx >> 1) == 0)).sum((1, 2)))
