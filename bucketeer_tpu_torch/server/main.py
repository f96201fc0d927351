"""Server entry point: ``python -m bucketeer_tpu_torch.server.main
[--device cuda|cpu]`` — the JAX package's server/main.py on one device
(default "cuda"; without a CUDA device it raises, it never moves to the
CPU on its own). Needs aiohttp.

Boot sequence port (reference: verticles/MainVerticle.java:83-166 — load
config, install the JobFactory path prefix, build the router, listen).
"""
from __future__ import annotations

import argparse
import logging

from aiohttp import web

from .. import config as cfg
from .. import job_factory
from ..engine import Engine
from ..utils import path_prefix as pp
from .app import build_app


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Bucketeer CUDA server")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--config", default=None,
                        help="properties file (or set BUCKETEER_CONFIG)")
    parser.add_argument("--device", default="cuda",
                        help="device of the converter, scheduler and "
                             "readers: cuda (default) or cpu")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    # Request-id stamping first (log correlation): every record then
    # carries %(request_id)s — "-" outside a request — independent of
    # whether tracing itself is enabled.
    from ..obs import logctx
    logctx.install()
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s "
               "[%(request_id)s]: %(message)s")

    config = cfg.Config.load(args.config)
    port = args.port or config.get_int(cfg.HTTP_PORT)

    # Install the image-mount path prefix (reference:
    # MainVerticle.java:92-102).
    mount = config.get_str(cfg.FILESYSTEM_IMAGE_MOUNT) or ""
    prefix_name = config.get_str(cfg.FILESYSTEM_PREFIX)
    job_factory.set_path_prefix(pp.get_prefix(prefix_name, mount))

    engine = Engine(config, device=args.device)
    app = build_app(engine)
    web.run_app(app, port=port)


if __name__ == "__main__":
    main()
