"""Sample transform and Tier-1 front-end: the port on the CPU against
the JAX package's jitted programs on the CPU, same numpy inputs."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import dwt as j_dwt
from bucketeer_tpu.codec import frontend as j_frontend
from bucketeer_tpu.codec import pipeline as j_pipeline
from bucketeer_tpu.codec import transforms as j_transforms
from bucketeer_tpu_torch.codec import dwt as t_dwt
from bucketeer_tpu_torch.codec import frontend as t_frontend
from bucketeer_tpu_torch.codec import pipeline as t_pipeline
from bucketeer_tpu_torch.codec import transforms as t_transforms


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


# --- the inverse transforms (the read path) -------------------------------

def _bands(seed, b, h, w, levels, reversible):
    """Random subbands of an (h, w) tile: odd magnitudes of both signs
    for the 5/3 (the arithmetic shifts' corner), floats for the 9/7."""
    rng = np.random.default_rng(seed)
    (lh, lw), shapes = t_dwt.subband_shapes(h, w, levels)

    def band(shape):
        if reversible:
            mag = rng.integers(0, 600, (b,) + shape) * 2 + 1
            sign = np.where(rng.random((b,) + shape) < 0.5, -1, 1)
            return (mag * sign).astype(np.int32)
        return rng.normal(0, 40, (b,) + shape).astype(np.float32)

    ll = band((lh, lw))
    bands = [{k: band(v) for k, v in lvl.items()} for lvl in shapes]
    return ll, bands


_J_INVERSE = jax.jit(j_dwt.dwt2d_inverse, static_argnums=2)


def _both_inverse(ll, bands, reversible):
    ref = np.asarray(_J_INVERSE(ll, bands, reversible))
    got = t_dwt.dwt2d_inverse(
        torch.as_tensor(ll),
        [{k: torch.as_tensor(v) for k, v in lvl.items()} for lvl in bands],
        reversible).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    return ref, got


@pytest.mark.parametrize("h,w,levels", [
    (1, 1, 1), (1, 8, 2), (8, 1, 2), (7, 5, 3), (2, 3, 1), (9, 9, 3),
    (4, 6, 2), (33, 17, 5), (64, 64, 4)])
def test_inverse_53_identical(h, w, levels):
    """5/3 synthesis is integer-exact against JAX, axes of 1-9 samples
    included (the extension reflects more than once there)."""
    ref, got = _both_inverse(*_bands(h * w + levels, 2, h, w, levels,
                                     True), True)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h,w,levels", [
    (1, 8, 2), (7, 5, 3), (9, 9, 3), (33, 17, 5), (64, 64, 4)])
def test_inverse_97_close(h, w, levels):
    """9/7 synthesis within rtol 1e-5 (of the output's scale) of JAX:
    float32 steps in the same order, rounded by another compiler."""
    ref, got = _both_inverse(*_bands(h + w + levels, 2, h, w, levels,
                                     False), False)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_forward_then_inverse_53_is_lossless():
    x = np.random.default_rng(3).integers(-128, 128, (2, 37, 29),
                                          dtype=np.int32)
    ll, bands = t_dwt.dwt2d_forward(torch.as_tensor(x), 4, True)
    np.testing.assert_array_equal(
        t_dwt.dwt2d_inverse(ll, bands, True).numpy(), x)


def test_interleave_with_empty_high_band():
    for lo, hi in ((np.arange(2, dtype=np.int32).reshape(2, 1),
                    np.zeros((2, 0), np.int32)),
                   (np.arange(6, dtype=np.int32).reshape(2, 3),
                    -np.arange(4, dtype=np.int32).reshape(2, 2) - 1)):
        ref = np.asarray(j_dwt._interleave(lo, hi))
        got = t_dwt._interleave(torch.as_tensor(lo),
                                torch.as_tensor(hi)).numpy()
        np.testing.assert_array_equal(got, ref)


def test_colour_inverses_against_jax():
    rng = np.random.default_rng(5)
    ycc = rng.integers(-300, 300, (4, 7, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        t_transforms.rct_inverse(torch.as_tensor(ycc)).numpy(),
        np.asarray(j_transforms.rct_inverse(ycc)))
    rgb = rng.integers(-128, 128, (5, 6, 3)).astype(np.int32)
    back = t_transforms.rct_inverse(
        t_transforms.rct_forward(torch.as_tensor(rgb)))
    np.testing.assert_array_equal(back.numpy(), rgb)
    f = rng.normal(0, 60, (9, 11, 3)).astype(np.float32)
    ref = np.asarray(j_transforms.ict_inverse(f))
    got = t_transforms.ict_inverse(torch.as_tensor(f)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    np.testing.assert_array_equal(
        t_transforms.level_shift_inverse(torch.as_tensor(ycc), 8).numpy(),
        np.asarray(j_transforms.level_shift_inverse(ycc, 8)))
