"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics with the service as deployed; ``--trace 1`` adds the profiler
and the stage sink and reports its per-layer metrics. See README.md.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="also read the control of the check (the reference "
                        "one precision step down) and print it on stderr; "
                        "measurement runs leave it off")
    args = p.parse_args(argv)
    # Build and kernel caches stay in the checkout, at fixed paths.
    cache = os.path.join(ROOT, ".bench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    from benchmark.harness import cell
    try:
        return cell.run(args, T_START)
    finally:
        sched = sys.modules.get("bucketeer_tpu_torch.engine.scheduler")
        if sched is not None and sched.torch.cuda.is_available():
            sched.get_scheduler("cuda").close()


if __name__ == "__main__":
    sys.exit(main())
