"""The PyTorch port stands alone: importing every module of
bucketeer_tpu_torch loads neither JAX nor anything of bucketeer_tpu, and
no source of the port names ml_dtypes (which the card's machine does not
have)."""
import json
import os
import subprocess
import sys

import bucketeer_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import bucketeer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    bucketeer_tpu_torch.__path__, "bucketeer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
new = sorted(set(sys.modules) - before)
print(json.dumps({"modules": names, "new": new}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # Every module of the package was imported, the kernel module too.
    assert {"bucketeer_tpu_torch.kernels.fused_t1",
            "bucketeer_tpu_torch.kernels.cxd_scan",
            "bucketeer_tpu_torch.kernels.mq_scan",
            "bucketeer_tpu_torch.kernels.support",
            "bucketeer_tpu_torch.kernels.build",
            "bucketeer_tpu_torch.codec.t1_batch",
            "bucketeer_tpu_torch.codec.decode.decoder",
            "bucketeer_tpu_torch.codec.decode.device",
            "bucketeer_tpu_torch.codec.decode.parser",
            "bucketeer_tpu_torch.converters.reader",
            "bucketeer_tpu_torch.converters.cuda",
            "bucketeer_tpu_torch.tensor",
            "bucketeer_tpu_torch.tensor.planes",
            "bucketeer_tpu_torch.tensor.container",
            "bucketeer_tpu_torch.tensor.codec",
            "bucketeer_tpu_torch.tensor.coeffs",
            "bucketeer_tpu_torch.engine",
            "bucketeer_tpu_torch.engine.scheduler",
            "bucketeer_tpu_torch.engine.faults",
            "bucketeer_tpu_torch.obs",
            "bucketeer_tpu_torch.obs.trace",
            "bucketeer_tpu_torch.obs.flight",
            "bucketeer_tpu_torch.obs.export",
            "bucketeer_tpu_torch.obs.logctx",
            "bucketeer_tpu_torch.obs.slo",
            "bucketeer_tpu_torch.obs.__main__",
            "bucketeer_tpu_torch.server.metrics",
            "bucketeer_tpu_torch.server.app",
            "bucketeer_tpu_torch.server.main",
            "bucketeer_tpu_torch.utils.path_prefix",
            "bucketeer_tpu_torch.constants",
            "bucketeer_tpu_torch.op",
            "bucketeer_tpu_torch.http_codes",
            "bucketeer_tpu_torch.features",
            "bucketeer_tpu_torch.config",
            "bucketeer_tpu_torch.models",
            "bucketeer_tpu_torch.job_factory",
            "bucketeer_tpu_torch.converters.cli",
            "bucketeer_tpu_torch.converters.factory",
            "bucketeer_tpu_torch.engine.retry",
            "bucketeer_tpu_torch.engine.bus",
            "bucketeer_tpu_torch.engine.journal",
            "bucketeer_tpu_torch.engine.store",
            "bucketeer_tpu_torch.engine.s3",
            "bucketeer_tpu_torch.engine.slack",
            "bucketeer_tpu_torch.engine.workers",
            "bucketeer_tpu_torch.engine.batch",
            "bucketeer_tpu_torch.engine.core",
            "bucketeer_tpu_torch.engine.chaos",
            "bucketeer_tpu_torch.parallel",
            "bucketeer_tpu_torch.parallel.mesh",
            "bucketeer_tpu_torch.parallel.batch",
            "bucketeer_tpu_torch.parallel.sharded_dwt",
            "bucketeer_tpu_torch.batches",
            "bucketeer_tpu_torch.batches.recipe",
            "bucketeer_tpu_torch.batches.store",
            "bucketeer_tpu_torch.batches.assemble",
            "bucketeer_tpu_torch.analysis",
            "bucketeer_tpu_torch.analysis.__main__",
            "bucketeer_tpu_torch.analysis.abi",
            "bucketeer_tpu_torch.analysis.deviceaudit",
            "bucketeer_tpu_torch.analysis.graftcost",
            "bucketeer_tpu_torch.analysis.graftmesh",
            "bucketeer_tpu_torch.analysis.rules_perf",
            "bucketeer_tpu_torch.analysis.rules_shard",
            "bucketeer_tpu_torch.obs.cost",
            "bucketeer_tpu_torch.analysis.findings",
            "bucketeer_tpu_torch.analysis.lint",
            "bucketeer_tpu_torch.analysis.rules_async",
            "bucketeer_tpu_torch.analysis.rules_hygiene",
            "bucketeer_tpu_torch.analysis.rules_lockorder",
            "bucketeer_tpu_torch.analysis.rules_locks",
            "bucketeer_tpu_torch.analysis.rules_obs",
            "bucketeer_tpu_torch.analysis.graftrace",
            "bucketeer_tpu_torch.analysis.graftrace.detector",
            "bucketeer_tpu_torch.analysis.graftrace.explore",
            "bucketeer_tpu_torch.analysis.graftrace.runtime",
            "bucketeer_tpu_torch.analysis.graftrace.scenarios",
            "bucketeer_tpu_torch.analysis.graftrace.seam"} \
        <= set(res["modules"])
    bad = [m for m in res["new"]
           if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "bucketeer_tpu" or m.startswith("bucketeer_tpu.")
           or m == "ml_dtypes" or m.startswith("ml_dtypes.")]
    assert bad == []


def _port_sources() -> list:
    root = bucketeer_tpu_torch.__path__[0]
    paths = [os.path.join(d, f) for d, _, files in os.walk(root)
             for f in files if f.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, f) for f in (
        "chip_smoke.py", "t1_ab.py", "sched_pool_ab.py", "mesh_cards.py")]


def test_port_sources_name_no_jax_import():
    """No source line of the port or of its card scripts imports JAX or
    the JAX package, even behind a function (a lazy import would escape the
    probe above)."""
    paths = _port_sources()
    rel = {os.path.relpath(p, REPO) for p in paths}
    assert {"bucketeer_tpu_torch/kernels/fused_t1.py",
            "bucketeer_tpu_torch/kernels/cxd_scan.py",
            "bucketeer_tpu_torch/kernels/mq_scan.py",
            "bucketeer_tpu_torch/kernels/support.py",
            "bucketeer_tpu_torch/codec/t1_batch.py",
            "bucketeer_tpu_torch/codec/encoder.py",
            "bucketeer_tpu_torch/codec/decode/decoder.py",
            "bucketeer_tpu_torch/converters/reader.py",
            "bucketeer_tpu_torch/tensor/__init__.py",
            "bucketeer_tpu_torch/tensor/planes.py",
            "bucketeer_tpu_torch/tensor/container.py",
            "bucketeer_tpu_torch/tensor/codec.py",
            "bucketeer_tpu_torch/tensor/coeffs.py",
            "bucketeer_tpu_torch/engine/__init__.py",
            "bucketeer_tpu_torch/engine/scheduler.py",
            "bucketeer_tpu_torch/engine/faults.py",
            "bucketeer_tpu_torch/obs/__init__.py",
            "bucketeer_tpu_torch/obs/trace.py",
            "bucketeer_tpu_torch/obs/flight.py",
            "bucketeer_tpu_torch/obs/export.py",
            "bucketeer_tpu_torch/obs/logctx.py",
            "bucketeer_tpu_torch/obs/slo.py",
            "bucketeer_tpu_torch/server/metrics.py",
            "bucketeer_tpu_torch/server/app.py",
            "bucketeer_tpu_torch/server/main.py",
            "bucketeer_tpu_torch/obs/__main__.py",
            "bucketeer_tpu_torch/config.py",
            "bucketeer_tpu_torch/models.py",
            "bucketeer_tpu_torch/job_factory.py",
            "bucketeer_tpu_torch/converters/cli.py",
            "bucketeer_tpu_torch/converters/factory.py",
            "bucketeer_tpu_torch/engine/bus.py",
            "bucketeer_tpu_torch/engine/journal.py",
            "bucketeer_tpu_torch/engine/store.py",
            "bucketeer_tpu_torch/engine/s3.py",
            "bucketeer_tpu_torch/engine/slack.py",
            "bucketeer_tpu_torch/engine/workers.py",
            "bucketeer_tpu_torch/engine/batch.py",
            "bucketeer_tpu_torch/engine/core.py",
            "bucketeer_tpu_torch/engine/chaos.py",
            "bucketeer_tpu_torch/parallel/mesh.py",
            "bucketeer_tpu_torch/parallel/batch.py",
            "bucketeer_tpu_torch/parallel/sharded_dwt.py",
            "bucketeer_tpu_torch/batches/recipe.py",
            "bucketeer_tpu_torch/batches/store.py",
            "bucketeer_tpu_torch/batches/assemble.py",
            "bucketeer_tpu_torch/analysis/__init__.py",
            "bucketeer_tpu_torch/analysis/__main__.py",
            "bucketeer_tpu_torch/analysis/abi.py",
            "bucketeer_tpu_torch/analysis/lint.py",
            "bucketeer_tpu_torch/analysis/graftrace/explore.py",
            "bucketeer_tpu_torch/analysis/graftrace/scenarios.py",
            "bucketeer_tpu_torch/analysis/graftrace/seam.py",
            "chip_smoke.py", "t1_ab.py", "sched_pool_ab.py",
            "mesh_cards.py"} <= rel
    offenders = []
    for path in paths:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                s = line.strip()
                if s.startswith(("import jax", "from jax",
                                 "import bucketeer_tpu ",
                                 "from bucketeer_tpu ",
                                 "from bucketeer_tpu.",
                                 "import bucketeer_tpu.")):
                    offenders.append(f"{path}:{n}: {s}")
    assert offenders == []


def test_port_sources_name_no_ml_dtypes():
    """bfloat16 is torch.bfloat16 in the port: no source line of the port
    or of its card scripts names ml_dtypes, in code or in prose."""
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                if "ml_dtypes" in line:
                    offenders.append(f"{path}:{n}: {line.strip()}")
    assert offenders == []


_BLOCKED = """
import importlib.abc, json, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("aiohttp", "PIL"):
            raise ImportError(f"{name} is not installed here")
        return None


sys.meta_path.insert(0, Refuse())
import bucketeer_tpu_torch.engine
import bucketeer_tpu_torch.server.metrics
import bucketeer_tpu_torch.converters
from bucketeer_tpu_torch.engine import Engine, FakeS3Client
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("aiohttp", "PIL"))))
"""


def test_card_path_imports_without_aiohttp_and_pil():
    """The card's machine has neither aiohttp nor PIL: the engine, the
    metrics sink and the converters import there (only the HTTP app, its
    entry point and the real S3/Slack clients need aiohttp)."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
