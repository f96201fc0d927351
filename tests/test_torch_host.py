"""The port's host tables, types and copied host modules equal the JAX
package's: coding tables (ZC, SC, Qe), the MQ encoder, quantizer
signaling, plan geometry and steps, and the verbatim back half."""
import ast
import dataclasses
import os

import numpy as np
import pytest

from bucketeer_tpu.codec import cxd as j_cxd
from bucketeer_tpu.codec import dwt as j_dwt
from bucketeer_tpu.codec import mq as j_mq
from bucketeer_tpu.codec import pipeline as j_pipeline
from bucketeer_tpu.codec import quant as j_quant
from bucketeer_tpu.codec import t1 as j_t1
from bucketeer_tpu_torch.codec import dwt as t_dwt
from bucketeer_tpu_torch.codec import mq as t_mq
from bucketeer_tpu_torch.codec import pipeline as t_pipeline
from bucketeer_tpu_torch.codec import quant as t_quant
from bucketeer_tpu_torch.codec import t1 as t_t1
from bucketeer_tpu_torch.kernels import fused_t1 as t_fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_coding_tables_equal():
    np.testing.assert_array_equal(t_t1.zc_stack(), j_cxd._zc_stack())
    for got, ref in zip(t_t1.sc_tables(), j_cxd._sc_tables()):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.asarray(t_mq.QE_TABLE, np.int32),
                                  j_cxd._QE_ARR)
    assert t_t1.BAND_CLS == j_t1.BAND_CLS
    assert (t_mq.CTX_RL, t_mq.CTX_UNIFORM, t_mq.N_CONTEXTS) == (
        j_mq.CTX_RL, j_mq.CTX_UNIFORM, j_mq.N_CONTEXTS)
    assert t_mq.initial_states() == j_mq.initial_states()
    tabs = t_fused.tables("cpu")
    np.testing.assert_array_equal(tabs["zc"].numpy(), j_cxd._zc_stack())
    np.testing.assert_array_equal(tabs["qe"].numpy(), j_cxd._QE_ARR)


def test_kernel_sizing_equal():
    for L in (1, 2, 5, 8, 16, 32):
        assert t_fused.max_syms(L) == j_cxd.max_syms(L)
        assert t_fused.mq_capacity(t_fused.max_syms(L)) == \
            j_cxd.mq_capacity(j_cxd.max_syms(L))
    assert t_fused.MQ_ROW_BYTES == j_cxd.MQ_ROW_BYTES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mq_encoder_equal(seed):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 19, 3000) | (rng.integers(0, 2, 3000) << 5)
    a, b = t_mq.MQEncoder(), j_mq.MQEncoder()
    lens = []
    for s in syms:
        a.encode(int(s) >> 5, int(s) & 31)
        b.encode(int(s) >> 5, int(s) & 31)
        lens.append((a.truncation_length(), b.truncation_length()))
    assert all(x == y for x, y in lens)
    assert a.flush() == b.flush()


def test_quant_signaling_equal():
    assert (t_quant.FRAC_BITS, t_quant.GUARD_BITS) == (
        j_quant.FRAC_BITS, j_quant.GUARD_BITS)
    for band in ("LL", "HL", "LH", "HH"):
        for bd in (8, 12, 16):
            for extra in (0, 1):
                assert dataclasses.astuple(t_quant.signal_reversible(
                    bd, band, extra_bits=extra)) == dataclasses.astuple(
                    j_quant.signal_reversible(bd, band, extra_bits=extra))
            for delta in (0.013, 0.5, 1.0, 2.7, 40.0):
                assert dataclasses.astuple(t_quant.signal_irreversible(
                    delta, bd, band)) == dataclasses.astuple(
                    j_quant.signal_irreversible(delta, bd, band))


@pytest.mark.parametrize("levels,lossless", [(1, True), (5, True),
                                             (6, False), (3, False)])
def test_synthesis_gains_equal(levels, lossless):
    assert t_dwt.synthesis_gains(levels, lossless) == \
        j_dwt.synthesis_gains(levels, lossless)
    assert t_dwt.subband_shapes(97, 64, levels) == \
        j_dwt.subband_shapes(97, 64, levels)


@pytest.mark.parametrize("shape", [
    (64, 64, 1, 5, True, 8, 0.5, None),
    (512, 512, 3, 6, True, 8, 1.0, True),
    (512, 512, 3, 6, False, 8, 2.0, True),
    (96, 37, 1, 3, False, 16, 512.0, None),
    (33, 17, 3, 2, False, 8, 0.5, False),
])
def test_plan_and_step_map_equal(shape):
    """The per-plan state both packages share: slot geometry, signaled
    quantizers and the quantizer step map."""
    tp = t_pipeline.make_plan(*shape)
    jp = j_pipeline.make_plan(*shape)
    assert [dataclasses.astuple(s) for s in tp.slots] == \
        [dataclasses.astuple(s) for s in jp.slots]
    assert (tp.tile_h, tp.tile_w, tp.n_comps, tp.levels, tp.lossless,
            tp.bitdepth, tp.base_delta, tp.used_mct) == (
        jp.tile_h, jp.tile_w, jp.n_comps, jp.levels, jp.lossless,
        jp.bitdepth, jp.base_delta, jp.used_mct)
    np.testing.assert_array_equal(t_pipeline._step_map(tp),
                                  j_pipeline._step_map(jp))


@pytest.mark.parametrize("rel", [
    "codec/rate.py", "codec/t2.py", "codec/codestream.py", "codec/jp2.py",
    "codec/tiff.py", "converters/base.py", "codec/decode/parser.py",
    "codec/decode/index.py",
    # the service stack's host modules
    "utils/__init__.py", "utils/path_prefix.py", "constants.py", "op.py",
    "http_codes.py", "features.py", "config.py", "models.py",
    "job_factory.py", "engine/journal.py", "engine/s3.py",
    "engine/slack.py", "engine/workers.py", "converters/cli.py",
    "server/openapi.yaml", "server/webroot/index.html",
    "server/webroot/error.html", "server/webroot/success.html",
    "server/webroot/docs/index.html",
    "server/webroot/upload/csv/index.html",
    # the batch data plane's request validation
    "batches/recipe.py",
    # the flight recorder, and the race explorer's and the host lint's
    # modules that read no JAX program
    "obs/flight.py", "analysis/findings.py",
    "analysis/graftrace/__init__.py", "analysis/graftrace/seam.py",
    "analysis/graftrace/runtime.py", "analysis/graftrace/detector.py",
    "analysis/rules_locks.py", "analysis/rules_lockorder.py",
    "analysis/rules_hygiene.py", "analysis/rules_async.py"])
def test_host_module_is_verbatim_copy(rel):
    """The back half and the service's host modules are copied, not
    re-implemented: same source text."""
    with open(os.path.join(REPO, "bucketeer_tpu_torch", rel)) as fh:
        got = fh.read()
    with open(os.path.join(REPO, "bucketeer_tpu", rel)) as fh:
        ref = fh.read()
    assert got == ref


def _code_without_docstrings(path: str, cls: str | None = None) -> str:
    """ast dump of a module (or of its class ``cls``), docstrings
    dropped."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    if cls is not None:
        tree = next(n for n in tree.body
                    if isinstance(n, ast.ClassDef) and n.name == cls)
    return ast.dump(tree)


@pytest.mark.parametrize("rel,cls", [
    ("codec/decode/t1_dec.py", None), ("codec/decode/errors.py", None),
    ("codec/mq.py", "MQDecoder"), ("engine/faults.py", None),
    ("engine/chaos.py", None), ("engine/retry.py", None),
    ("engine/bus.py", None), ("engine/store.py", None),
    ("server/metrics.py", None), ("converters/reader.py", "_DecodeCache"),
    ("converters/reader.py", "_IndexCache"),
    ("analysis/rules_obs.py", None)])
def test_decode_code_is_a_copy(rel, cls):
    """The read path's host Tier-1, error types and MQ decoder, the
    engine's fault injection, chaos CLI, retry policy, bus and job
    store, the metrics sink and the reader's caches (with their race
    explorer seam calls), and the tracing lint rule, are the JAX
    package's code; only docstrings and comments that name the other
    package's modules or its history differ."""
    got, ref = (_code_without_docstrings(os.path.join(REPO, pkg, rel), cls)
                for pkg in ("bucketeer_tpu_torch", "bucketeer_tpu"))
    assert got == ref


def _cpp_code(path: str) -> list:
    """A C++ source's code lines: ``//`` comments, trailing blanks and
    empty lines dropped."""
    out = []
    for line in open(path).read().splitlines():
        code = line.split("//", 1)[0].rstrip()
        if code:
            out.append(code)
    return out


def test_host_coder_is_a_copy():
    """csrc/host_t1.cpp is the JAX package's native/t1.cpp: the block
    coder, its thread pool and all three entries, line for line; only
    comments (the file note with its build line among them) differ."""
    got = _cpp_code(os.path.join(REPO, "bucketeer_tpu_torch", "csrc",
                                 "host_t1.cpp"))
    ref = _cpp_code(os.path.join(REPO, "bucketeer_tpu", "native",
                                 "t1.cpp"))
    assert got == ref
    for entry in ("t1_encode_blocks", "t1_encode_packed", "t1_encode_cxd"):
        assert any(entry + "(" in line for line in got)
