"""The port's MQ coder over given symbol streams (kernels/mq_scan.py, the
plain version that CPU tensors run) against the JAX package's batched
``cxd._mq_run`` on random streams, as tests/test_mq_device.py draws
them: byte buffers, pass snapshots, data lengths and byte cursors,
exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import cxd as j_cxd
from bucketeer_tpu_torch.kernels import cxd_scan as t_scan
from bucketeer_tpu_torch.kernels import mq_scan as t_mq

L, N_STEPS = 2, 1024


def _streams(seed):
    """Three random streams: 900 symbols, none (never flushed), 1024."""
    rng = np.random.default_rng(seed)
    msym = t_scan.max_syms(L)
    sym = (rng.integers(0, 19, (3, msym))
           | (rng.integers(0, 2, (3, msym)) << 5)).astype(np.uint8)
    totals = np.array([900, 0, 1024], np.int32)
    counts = np.stack([
        np.sort(rng.integers(0, t + 1, L * 3)).reshape(L, 3)
        for t in totals]).astype(np.int32)
    flags = (totals > 0).astype(np.int32)
    return sym, counts, totals, flags


@pytest.mark.parametrize("seed", [0, 1])
def test_mq_scan_matches_jax_mq_run(seed):
    sym, counts, totals, flags = _streams(seed)
    cap = t_mq.mq_capacity(N_STEPS)
    assert cap == j_cxd.mq_capacity(N_STEPS)
    ref = [np.asarray(x) for x in j_cxd._mq_run(
        L, N_STEPS, cap, jnp.asarray(sym), jnp.asarray(counts),
        jnp.asarray(totals), jnp.asarray(flags))]
    got = [t.numpy() for t in t_mq.mq_scan(
        L, N_STEPS, cap, *(torch.as_tensor(a)
                           for a in (sym, counts, totals, flags)))]
    for g, r, name in zip(got, ref, ("bytes", "snaps", "dlen", "cursor")):
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert ref[2][1] == 0 and ref[2][0] > 0 and ref[2][2] > 0


@pytest.mark.parametrize("n_steps", [1020, 1000])
def test_mq_scan_rejects_bad_step_budget(n_steps):
    """A budget that is not a multiple of MQ_UNROLL (1020), or that is
    below a block's total (1000 < 1024), raises."""
    sym, counts, totals, flags = (torch.as_tensor(a) for a in _streams(0))
    with pytest.raises(ValueError, match="n_steps"):
        t_mq.mq_scan(L, n_steps, t_mq.mq_capacity(1024), sym, counts,
                     totals, flags)


def test_mq_scan_rejects_total_past_stream():
    sym, counts, totals, flags = (torch.as_tensor(a) for a in _streams(0))
    with pytest.raises(ValueError, match="exceeds"):
        t_mq.mq_scan(L, N_STEPS, t_mq.mq_capacity(N_STEPS),
                     sym[:, :1000].contiguous(), counts, totals, flags)
