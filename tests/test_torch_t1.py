"""The plain PyTorch fused Tier-1 (kernels/fused_t1.py, what the wrapper
runs for CPU tensors) against the JAX package's jnp fused Tier-1: the
shared CX/D scan (``cxd._scan_impl``) chained into the batched MQ run
(``cxd._mq_run``), as tests/test_mq_device.py composes it. All seven
outputs are compared exactly — distortion pairs bit for bit. The plain
CX/D scan alone (kernels/cxd_scan.py) is held against ``cxd._scan_impl``
and the port's 6-bit packing against ``cxd.pack6`` the same way."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import cxd as j_cxd
from bucketeer_tpu_torch.codec import cxd as t_cxd
from bucketeer_tpu_torch.kernels import cxd_scan as t_scan
from bucketeer_tpu_torch.kernels import fused_t1 as t_fused


@lru_cache(maxsize=2)
def _jax_scan(L):
    return jax.jit(j_cxd._scan_impl(L, False, False))


@lru_cache(maxsize=2)
def _jax_mq(L):
    def run(buf, counts, cur, flags):
        cap = j_cxd.mq_capacity(j_cxd.max_syms(L))
        return j_cxd._mq_run_while(L, cap, buf, counts, cur, flags)
    return jax.jit(run)


def _blocks(seed, L, frac):
    """Blocks of every kind the main path produces: full and partial
    extents, all three band classes, an all-zero block, a floored-dead
    block and a partly floored one."""
    rng = np.random.default_rng(seed)
    hw = [(64, 64), (13, 37), (64, 5), (8, 8), (7, 64), (40, 40),
          (24, 64)]
    n = len(hw)
    blocks = np.zeros((n, 64, 64), np.int64)
    for i, (h, w) in enumerate(hw):
        dens = 0.2 if i == 0 else 0.08
        mags = (rng.random((h, w)) < dens) * rng.integers(
            0, 1 << (L + frac), size=(h, w))
        blocks[i, :h, :w] = mags * np.where(rng.random((h, w)) < 0.5,
                                            -1, 1)
    blocks[3] = 0
    idx = np.abs(blocks) >> frac
    nbps = np.array([int(b.max()).bit_length() for b in idx], np.int32)
    floors = np.zeros(n, np.int32)
    floors[5] = nbps[5]                    # floored away entirely
    floors[6] = 1
    cls = np.array([0, 2, 1, 0, 2, 1, 0], np.int32)
    hs = np.array([h for h, _ in hw], np.int32)
    ws = np.array([w for _, w in hw], np.int32)
    return blocks.astype(np.int32), nbps, floors, cls, hs, ws


def check_plain_matches_jax(L, frac):
    blocks, nbps, floors, cls, hs, ws = _blocks(L * 10 + frac, L, frac)
    buf, counts, dh, dl, cur = _jax_scan(L)(
        jnp.int32(frac), jnp.asarray(blocks), jnp.asarray(nbps),
        jnp.asarray(floors), jnp.asarray(cls), jnp.asarray(hs),
        jnp.asarray(ws))
    flags = jnp.asarray((nbps > floors).astype(np.int32))
    rows, snaps, dlen, curb = _jax_mq(L)(buf, counts, cur, flags)
    ref = [np.asarray(x) for x in (rows, snaps, dlen, dh, dl, cur, curb)]

    got = [t.numpy() for t in t_fused.fused_t1(
        L, frac, *(torch.as_tensor(a) for a in
                   (blocks, nbps, floors, cls, hs, ws)))]
    n = len(nbps)
    cap = t_fused.mq_capacity(t_fused.max_syms(L))
    g_rows, r_rows = got[0].reshape(n, cap), ref[0].reshape(n, cap)
    for b in range(n):
        # Bytes past the data length carry no meaning.
        d = int(ref[2][b])
        np.testing.assert_array_equal(g_rows[b, 1:1 + d],
                                      r_rows[b, 1:1 + d], err_msg=f"{b}")
    for k in (1, 2, 5, 6):          # snaps, dlen, cur, curb
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"out {k}")
    for k in (3, 4):                # dh, dl: bit-identical float32
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      ref[k].view(np.int32))
    assert ref[5][3] == 0 and ref[5][5] == 0 and ref[2][5] == 0
    assert ref[5][0] > 1000          # the dense block really coded


def check_cxd_scan_matches_jax(L, frac):
    """cxd_scan on CPU tensors (its plain version) against the JAX jnp
    scan: symbols over each block's [0, cur), counts, cursors, and the
    distortion pairs bit for bit; then the port's pack6 of the JAX
    symbol buffer against the JAX package's pack6."""
    blocks, nbps, floors, cls, hs, ws = _blocks(L * 10 + frac, L, frac)
    ref = [np.asarray(x) for x in _jax_scan(L)(
        jnp.int32(frac), jnp.asarray(blocks), jnp.asarray(nbps),
        jnp.asarray(floors), jnp.asarray(cls), jnp.asarray(hs),
        jnp.asarray(ws))]
    got = [t.numpy() for t in t_scan.cxd_scan(
        L, frac, *(torch.as_tensor(a) for a in
                   (blocks, nbps, floors, cls, hs, ws)))]
    assert got[0].shape == ref[0].shape == (len(nbps), t_scan.max_syms(L))
    np.testing.assert_array_equal(got[4], ref[4])           # cursors
    for b, c in enumerate(ref[4]):
        np.testing.assert_array_equal(got[0][b, :c], ref[0][b, :c],
                                      err_msg=f"symbols of block {b}")
    np.testing.assert_array_equal(got[1], ref[1])           # counts
    for k in (2, 3):                                        # dh, dl
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      ref[k].view(np.int32))
    assert ref[4][0] > 1000 and ref[4][3] == 0 and ref[4][5] == 0
    packed = t_cxd.pack6(torch.as_tensor(ref[0].copy())).numpy()
    np.testing.assert_array_equal(packed, np.asarray(j_cxd.pack6(ref[0])))


@pytest.mark.parametrize("frac", [0, 7])
def test_plain_cxd_scan_matches_jax(frac):
    """L=2; tests/test_torch_t1_deep.py runs L=5."""
    check_cxd_scan_matches_jax(2, frac)


@pytest.mark.parametrize("frac", [0, 7])
def test_plain_fused_t1_matches_jax(frac):
    """L=2; tests/test_torch_t1_deep.py runs L=5 (each plane budget is
    its own JAX compile, so the two live in separate files)."""
    check_plain_matches_jax(2, frac)


def test_wrapper_rejects_device_without_kernel():
    """Tensors on a device with neither the kernel nor the plain path
    raise instead of being moved anywhere."""
    blocks = torch.zeros((1, 64, 64), dtype=torch.int32, device="meta")
    meta = [torch.zeros(1, dtype=torch.int32, device="meta")] * 5
    with pytest.raises(ValueError, match="no implementation"):
        t_fused.fused_t1(8, 0, blocks, *meta)
