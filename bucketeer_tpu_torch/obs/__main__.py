"""Sample-trace generator: ``python -m bucketeer_tpu_torch.obs
[--device cuda|cpu] [--synthetic] out.json``.

Runs one real (tiny) encode through the cross-request scheduler on
``--device`` (default "cuda") with tracing on and writes the request's
Chrome-trace JSON, so a real span tree can be dropped into
chrome://tracing or ui.perfetto.dev without booting the server.
``--synthetic`` writes a hand-built span tree instead and runs no
encode. Unlike the JAX package's CLI, a failed real encode is an error,
not a silent switch to the synthetic tree.
"""
from __future__ import annotations

import json
import sys
import time


def _synthetic_spans():
    from . import request_context, span

    with request_context("sample-request"):
        with span("http.getImage", method="GET", path="/images/sample"):
            with span("decode.queue_wait"):
                time.sleep(0.002)
            with span("decode.read"):
                with span("decode.t2_parse"):
                    time.sleep(0.001)
                with span("decode.t1"):
                    time.sleep(0.003)
                with span("decode.device_inverse"):
                    time.sleep(0.001)


def _real_encode(device: str):
    import numpy as np

    from ..codec.encoder import EncodeParams
    from ..engine.scheduler import EncodeScheduler
    from . import request_context, span

    sched = EncodeScheduler(device=device, window_s=0.005)
    try:
        img = np.linspace(0, 255, 96 * 96 * 3).reshape(
            96, 96, 3).astype(np.uint8)
        with request_context("sample-request"):
            with span("http.loadImage", method="GET",
                      path="/images/sample/sample.tif"):
                sched.encode_jp2(img, 8, EncodeParams(
                    lossless=True, levels=2), device=device)
    finally:
        sched.close()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    synthetic = "--synthetic" in argv
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("--device needs a value (cuda or cpu)", file=sys.stderr)
            return 2
        device = argv[i + 1]
        del argv[i:i + 2]
    paths = [a for a in argv if not a.startswith("-")]
    if len(paths) != 1:
        print("usage: python -m bucketeer_tpu_torch.obs [--device "
              "cuda|cpu] [--synthetic] OUT.json", file=sys.stderr)
        return 2

    from . import Recorder, chrome_trace, install

    install(Recorder())
    try:
        if synthetic:
            _synthetic_spans()
        else:
            _real_encode(device)
        doc = chrome_trace("sample-request")
    finally:
        install(None)
    with open(paths[0], "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
    print(f"wrote {len(doc['traceEvents'])} trace event(s) to "
          f"{paths[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
