"""The port's device-MQ half (codec/cxd.py run_device_mq: launch groups,
the fused Tier-1, row fetch, host assembly into columns) gives
code-blocks equal to the JAX package's run_device_mq, field for field."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import cxd as j_cxd
from bucketeer_tpu_torch.codec import cxd as t_cxd


def _chunk(seed):
    rng = np.random.default_rng(seed)
    n = 9
    blocks = np.zeros((n, 64, 64), np.int64)
    hs = rng.integers(1, 65, n).astype(np.int32)
    ws = rng.integers(1, 65, n).astype(np.int32)
    for i in range(n):
        h, w = hs[i], ws[i]
        mags = (rng.random((h, w)) < 0.15) * rng.integers(0, 1 << 6,
                                                          (h, w))
        blocks[i, :h, :w] = mags * np.where(rng.random((h, w)) < 0.5,
                                            -1, 1)
    blocks[4] = 0
    nbps = np.array([int(np.abs(b).max()).bit_length() for b in blocks],
                    np.int32)
    floors = np.zeros(n, np.int32)
    floors[2] = 2
    floors[7] = nbps[7]
    bands = ["LL", "HL", "LH", "HH", "LL", "HL", "LH", "HH", "HL"]
    return blocks.astype(np.int32), nbps, floors, bands, hs, ws


def test_launch_groups_equal():
    for seed in range(4):
        _, nbps, floors, *_ = _chunk(seed)
        tg, te = t_cxd._eff_groups(nbps, floors)
        jg, je = j_cxd._eff_groups(nbps, floors)
        np.testing.assert_array_equal(te, je)
        assert [(L, list(i)) for L, i in tg] == \
            [(L, list(i)) for L, i in jg]


@pytest.mark.parametrize("frac", [0, 7])
def test_run_device_mq_matches_jax(frac):
    blocks, nbps, floors, bands, hs, ws = _chunk(3)
    if frac:
        blocks = blocks * (1 << frac) + np.sign(blocks) * 37
        blocks = blocks.astype(np.int32)
    ref = j_cxd.run_device_mq(jnp.asarray(blocks), nbps, floors, bands,
                              hs, ws, 16, frac)
    got = t_cxd.run_device_mq(torch.as_tensor(blocks), nbps, floors,
                              bands, hs, ws, frac)
    assert got.total_syms == ref.total_syms
    assert got.total_bytes == ref.total_bytes
    blocks = got.cols.blocks()
    assert len(blocks) == len(ref.blocks)
    for i, (g, r) in enumerate(zip(blocks, ref.blocks)):
        assert g.data == r.data, f"block {i}"
        assert g.n_bitplanes == r.n_bitplanes
        assert [(p.pass_type, p.bitplane, p.cum_length, p.dist_reduction)
                for p in g.passes] == [
            (p.pass_type, p.bitplane, p.cum_length, p.dist_reduction)
            for p in r.passes], f"block {i}"
    assert blocks[4].data == b"" and not blocks[4].passes
