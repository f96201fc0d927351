"""The port's MQ coder over given symbol streams (kernels/mq_scan.py, the
plain version that CPU tensors run) against the JAX package's batched
``cxd._mq_run`` on random streams, as tests/test_mq_device.py draws
them: byte buffers, pass snapshots, data lengths and byte cursors,
exactly; and on streams made to stress the Hopper kernel's design
(chip_smoke.py ``mq_stress_streams``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import cxd as j_cxd
from bucketeer_tpu_torch.codec.mq import MQEncoder
from bucketeer_tpu_torch.kernels import cxd_scan as t_scan
from bucketeer_tpu_torch.kernels import mq_scan as t_mq
from chip_smoke import mq_stress_streams

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


# --- streams made to stress the kernel's design (chip_smoke.py holds the
# kernel to the plain version on the same streams) ----------------------

STRESS = mq_stress_streams()
_mq_run_jit = jax.jit(j_cxd._mq_run, static_argnums=(0, 1, 2))


@pytest.fixture(scope="module")
def stress_ref():
    """JAX ``_mq_run`` over every stress kind, one batched call per byte
    capacity: {kind: (bytes, snaps, dlen, cursor)} as numpy arrays."""
    by_cap = {}
    for kind, (L, steps, cap, *arrays) in STRESS.items():
        by_cap.setdefault((L, steps, cap), []).append((kind, arrays))
    out = {}
    for (L, steps, cap), kinds in by_cap.items():
        cat = [np.concatenate([a[k] for _, a in kinds]) for k in range(4)]
        ref = [np.asarray(x) for x in _mq_run_jit(
            L, steps, cap, *(jnp.asarray(a) for a in cat))]
        at = 0
        for kind, arrays in kinds:
            n = len(arrays[0])
            out[kind] = [r[at:at + n] for r in ref]
            at += n
    return out


@pytest.mark.parametrize("kind", list(STRESS))
def test_mq_scan_stress_matches_jax_mq_run(kind, stress_ref):
    L, steps, cap, sym, counts, totals, flags = STRESS[kind]
    got = [t.numpy() for t in t_mq.mq_scan(
        L, steps, cap, *(torch.as_tensor(a)
                         for a in (sym, counts, totals, flags)))]
    for g, r, name in zip(got, stress_ref[kind],
                          ("bytes", "snaps", "dlen", "cursor")):
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=f"{kind} {name}")


class _CountingEncoder(MQEncoder):
    """The host MQ encoder, counting BYTEOUT's carries, carries into a
    0xFF byte and bytes stuffed after 0xFF."""

    def __init__(self):
        super().__init__()
        self.events = {"carry": 0, "carry into 0xFF": 0, "stuffed": 0}

    def _byteout(self):
        if self.buf[-1] == 0xFF:
            self.events["stuffed"] += 1
        elif self.c >= 0x8000000:
            self.events["carry"] += 1
            self.events["carry into 0xFF"] += self.buf[-1] == 0xFE
        super()._byteout()


def test_stress_streams_stress_what_they_name():
    """Each kind holds what its name promises: totals around the kernel's
    staging chunk on aligned and unaligned rows, single-context runs,
    carries into 0xFF with stuffing, duplicate and out-of-range counts,
    empty streams, and more bytes than the capacity."""
    ch = t_mq.MQ_CHUNK
    L, steps, cap, sym, counts, totals, flags = STRESS["chunk"]
    assert set(totals) == {ch - 1, ch, ch + 1, 2 * ch - 1, 2 * ch, 2 * ch + 1}
    assert steps % 16 and all((totals[0::2] == totals[1::2]))
    _, _, _, sym, _, totals, _ = STRESS["one context"]
    assert [len(set(r & 31)) for r in sym[:3]] == [1, 1, 1]
    _, _, _, sym, _, totals, _ = STRESS["carry"]
    for row, total in zip(sym, totals):
        enc = _CountingEncoder()
        for s in row[:total]:
            enc.encode(int(s) >> 5, int(s) & 31)
        enc.flush()
        assert enc.events["carry into 0xFF"] >= 1, enc.events
        assert enc.events["stuffed"] >= 1, enc.events
    _, _, _, _, counts, totals, _ = STRESS["counts"]
    flat = counts.reshape(len(totals), -1)
    assert all(len(set(r)) < len(r) for r in flat)
    assert (flat <= 0).any() and (flat > totals[:, None]).any()
    _, _, _, _, _, totals, flags = STRESS["empty"]
    assert {(0, 0), (0, 1)} <= set(zip(totals, flags))
    L, steps, cap, sym, counts, totals, flags = STRESS["overflow"]
    _, _, dlen, _ = t_mq.mq_scan_plain(
        L, steps, cap, *(torch.as_tensor(a)
                         for a in (sym, counts, totals, flags)))
    assert (dlen > cap).all()


def test_chunk_matches_kernel_source():
    """MQ_CHUNK names the staging chunk of csrc/mq_scan.cu."""
    src = os.path.join(os.path.dirname(t_mq.__file__), "..", "csrc",
                       "mq_scan.cu")
    with open(src) as fh:
        assert f"constexpr int CHUNK = {t_mq.MQ_CHUNK};" in fh.read()
