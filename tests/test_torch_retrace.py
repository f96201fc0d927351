"""The port's kernel-build sentinel (bucketeer_tpu_torch/analysis/
retrace.py): the counterpart of tests/test_retrace.py. In eager PyTorch
the one compile stall is a native library's build at first use, so the
sentinel counts compiles (and, apart, loads of a built library) per
library. The g++ host Tier-1 library builds here, so it stands in for
the nvcc kernels."""
import threading

import numpy as np
import pytest

from bucketeer_tpu_torch.analysis import retrace
from bucketeer_tpu_torch.codec import t1_batch
from bucketeer_tpu_torch.kernels import build
from bucketeer_tpu_torch.server.metrics import Metrics


@pytest.fixture
def fresh_build_dir(tmp_path, monkeypatch):
    """An empty build directory: the next library() compiles."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path / "build"


def _host_t1():
    """A Library object of the host Tier-1's sources and table, apart
    from the module's own (which may be loaded already)."""
    lib = t1_batch.HOST_T1
    return build.Library(lib.name, tuple(s.rsplit("/", 1)[-1]
                                         for s in lib.sources),
                         lib.functions, cuda=False)


def test_sentinel_counts_builds_not_calls(fresh_build_dir):
    before = retrace.snapshot()
    lib = _host_t1()
    lib.library()
    lib.library()
    lib.build()
    assert retrace.delta(before) == {"host_t1": 1}
    # A second Library object of the same sources finds the built .so:
    # it loads, and compiles nothing.
    with retrace.expect_max_builds(0, libraries=("host_t1",)):
        other = _host_t1()
        other.library()
    after = retrace.snapshot()
    assert after["loaded"]["host_t1"] - before["loaded"].get(
        "host_t1", 0) == 2
    assert other.library().t1_abi_version() == \
        lib.library().t1_abi_version()


def test_expect_max_builds_fails_on_a_rebuild(fresh_build_dir):
    with pytest.raises(retrace.RetraceError, match="host_t1"):
        with retrace.expect_max_builds(0):
            _host_t1().library()


def test_a_warm_encode_builds_nothing():
    """The host Tier-1 encode of a warm process loads nothing new and
    compiles nothing (the library is built once per source hash)."""
    from bucketeer_tpu_torch.codec import encoder

    img = np.random.default_rng(3).integers(0, 256, (40, 48)).astype(
        np.uint8)
    params = encoder.EncodeParams(lossless=True, levels=2)
    encoder.encode_jp2(img, 8, params, device="cpu")        # warm
    with retrace.expect_max_builds(0):
        encoder.encode_jp2(img, 8, params, device="cpu")


def test_build_counts_survive_racing_bumps():
    """A cold library is reached from the scheduler's device workers,
    the Tier-1 pool and request threads at once; Counter.__iadd__ is a
    read-modify-write, so every bump goes through the lock. Hammering
    the bump directly races the exact increment path a build runs."""
    name = "hammer-library"
    before = retrace.snapshot()["built"].get(name, 0)
    n_threads, n_iters = 8, 2000
    start = threading.Barrier(n_threads)

    def worker():
        start.wait(timeout=60)
        for _ in range(n_iters):
            retrace.record_build(name)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert retrace.snapshot()["built"][name] - before == \
        n_threads * n_iters


def test_metrics_sink_counts_compiles(fresh_build_dir):
    sink = Metrics()
    retrace.set_metrics_sink(sink)
    try:
        lib = _host_t1()
        lib.library()
        lib.library()
        _host_t1().library()        # a load: no compile
    finally:
        retrace.set_metrics_sink(None)
    assert sink.report()["counters"]["retrace.host_t1"] == 1


async def test_app_metrics_show_builds(tmp_path, aiohttp_client,
                                       monkeypatch, fresh_build_dir):
    """The API server installs the sentinel's sink beside the encoder
    and decoder sinks: a library compile shows as retrace.<library> on
    GET /metrics."""
    from bucketeer_tpu_torch import config as cfg
    from bucketeer_tpu_torch.engine import (Engine, FakeS3Client,
                                            RecordingSlackClient)
    from bucketeer_tpu_torch.server.app import build_app

    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    config = cfg.Config.load(overrides={
        cfg.FILESYSTEM_IMAGE_MOUNT: str(tmp_path)})
    engine = Engine(config, device="cpu", s3_client=FakeS3Client(
        str(tmp_path / "s3")), slack_client=RecordingSlackClient())
    client = await aiohttp_client(build_app(engine))
    try:
        before = (await (await client.get("/metrics")).json()).get(
            "counters", {}).get("retrace.host_t1", 0)
        _host_t1().library()
        after = (await (await client.get("/metrics")).json()).get(
            "counters", {}).get("retrace.host_t1", 0)
    finally:
        retrace.set_metrics_sink(None)
    assert after - before == 1
