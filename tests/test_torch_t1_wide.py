"""The plain PyTorch CX/D scan and fused Tier-1 against the JAX jnp
versions (``cxd._scan_impl`` and ``cxd._mq_run_while``) at plane budget
L=32 on the deep corner the Hopper kernels must also get right: dense
blocks (about half the samples significant) at nbp 31 and 30 over full
64-row extents, so stripes reach row 63 and the shifts are at their
widest, and 1x64 and 64x1 blocks. All planes are coded (no floors).
Exact, distortion pairs bit for bit; see tests/test_torch_t1.py for the
comparisons. The dense blocks are narrow and the 1x64 block sits in its
own group, because the plain scan's time grows with the group's widest
and tallest extents times the depth."""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketeer_tpu_torch.kernels import cxd_scan as t_scan
from bucketeer_tpu_torch.kernels import fused_t1 as t_fused
from test_torch_t1 import _jax_mq, _jax_scan

L = 32
# (h, w, nbp, cls) per block; group "tall" holds the 64-row blocks,
# group "flat" the 1x64 ones beside a dense 2x64 block. Both groups have
# three blocks, so the JAX programs compile once.
GROUPS = {
    "tall": [(64, 5, 31, 0), (64, 4, 30, 1), (64, 1, 31, 2)],
    "flat": [(1, 64, 31, 1), (2, 64, 30, 2), (1, 64, 30, 0)],
}


@lru_cache(maxsize=None)
def _group(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    spec = GROUPS[name]
    n = len(spec)
    blocks = np.zeros((n, 64, 64), np.int64)
    for i, (h, w, nbp, _) in enumerate(spec):
        mags = (rng.random((h, w)) < 0.5) * rng.integers(
            1, 1 << nbp, size=(h, w), dtype=np.int64)
        mags[0, 0] = (1 << nbp) - 1
        blocks[i, :h, :w] = mags * np.where(rng.random((h, w)) < 0.5,
                                            -1, 1)
    nbps = np.array([s[2] for s in spec], np.int32)
    assert all(int(b.max()).bit_length() == p
               for b, p in zip(np.abs(blocks), nbps))
    return (blocks.astype(np.int32), nbps, np.zeros(n, np.int32),
            np.array([s[3] for s in spec], np.int32),
            np.array([s[0] for s in spec], np.int32),
            np.array([s[1] for s in spec], np.int32))


@lru_cache(maxsize=None)
def _jax_outputs(name):
    """The JAX scan, then the JAX MQ run over its symbols."""
    blocks, nbps, floors, cls, hs, ws = _group(name)
    scan = _jax_scan(L)(jnp.int32(0), *(jnp.asarray(a) for a in
                                        (blocks, nbps, floors, cls, hs, ws)))
    flags = jnp.asarray((nbps > floors).astype(np.int32))
    mq = _jax_mq(L)(scan[0], scan[1], scan[4], flags)
    return ([np.asarray(x) for x in scan], [np.asarray(x) for x in mq])


def _torch_args(name):
    return [torch.as_tensor(a) for a in _group(name)]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_plain_cxd_scan_matches_jax_l32(name):
    ref, _ = _jax_outputs(name)
    got = [t.numpy() for t in t_scan.cxd_scan(L, 0, *_torch_args(name))]
    np.testing.assert_array_equal(got[4], ref[4])           # cursors
    for b, c in enumerate(ref[4]):
        np.testing.assert_array_equal(got[0][b, :c], ref[0][b, :c],
                                      err_msg=f"symbols of block {b}")
    np.testing.assert_array_equal(got[1], ref[1])           # counts
    for k in (2, 3):                                        # dh, dl
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      ref[k].view(np.int32))
    # Every block coded all of its planes: the last plane offset's
    # cleanup count is the final cursor and the block is not tiny; and
    # some pass's distortion sum lies past int64's range.
    nbps = _group(name)[1]
    for b, p in enumerate(nbps):
        assert ref[1][b, p - 1, 2] == ref[4][b] > 100
    assert np.abs(ref[2].astype(np.float64)).max() > 2.0 ** 63


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_plain_fused_t1_matches_jax_l32(name):
    scan, mq = _jax_outputs(name)
    rows, snaps, dlen, curb = mq
    ref = [rows, snaps, dlen, scan[2], scan[3], scan[4], curb]
    got = [t.numpy() for t in t_fused.fused_t1(L, 0, *_torch_args(name))]
    n = len(ref[2])
    cap = t_fused.mq_capacity(t_fused.max_syms(L))
    g_rows, r_rows = got[0].reshape(n, cap), ref[0].reshape(n, cap)
    for b in range(n):
        d = int(ref[2][b])
        assert d > 0
        np.testing.assert_array_equal(g_rows[b, 1:1 + d],
                                      r_rows[b, 1:1 + d], err_msg=f"{b}")
    for k in (1, 2, 5, 6):          # snaps, dlen, cur, curb
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"out {k}")
    for k in (3, 4):                # dh, dl: bit-identical float32
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      ref[k].view(np.int32))
