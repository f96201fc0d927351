"""The one traffic generator's shared part. A mix (``traffic/<mix>.json``)
names its ``kind`` and its parameters; the kind is a file of its own,
``kinds/<kind>.py``, found by name (``spec.kind``), whose class ``Kind``
sets up the service the way a deployment runs it, warms up one request
of the cell's own shape, drives the window, and judges what the window
produced against the reference. What every kind shares is here: the
engine on a fake bucket, the seeded sources at the configuration's size,
components and bit depth, and the judging of landed files.
"""
from __future__ import annotations

import os
import struct
import urllib.parse

from ..reference import j2k, judge
from . import images

BUCKET = "bench"


def engine(workdir: str, device, conversion: str):
    """An Engine on a fake S3 bucket and a recording Slack client under
    ``workdir``, whose image mount is ``workdir``."""
    from bucketeer_tpu_torch import config as cfg
    from bucketeer_tpu_torch import features
    from bucketeer_tpu_torch.engine import (Engine, FakeS3Client,
                                            RecordingSlackClient)

    config = cfg.Config.load(overrides={
        cfg.S3_BUCKET: BUCKET,
        cfg.IIIF_URL: "https://iiif.bench/iiif",
        cfg.SLACK_CHANNEL_ID: "bench",
        cfg.FILESYSTEM_IMAGE_MOUNT: workdir,
        cfg.FILESYSTEM_CSV_MOUNT: os.path.join(workdir, "csv"),
        cfg.CONVERSION_TYPE: conversion,
        cfg.S3_REQUEUE_DELAY: 0.05})
    return Engine(config,
                  flags=features.FeatureFlagChecker(
                      static={features.FS_WRITE_CSV: True}),
                  s3_client=FakeS3Client(os.path.join(workdir, "s3")),
                  slack_client=RecordingSlackClient(), device=device)


class Base:
    """Shared set-up: the sources of the cell, made from the seed."""

    def __init__(self, ctx, mix: dict, config: dict) -> None:
        self.ctx = ctx
        self.mix = mix
        self.config = config
        self.h, self.w = config["image_rows"], config["image_columns"]
        self.components = config["components"]
        self.bitdepth = config["bitdepth"]
        self.pixels = self.h * self.w
        self.conversion = config["conversion"]
        self.sources = []          # (path, (h, w, components) array)
        self.landed_bytes = []     # (pixels, components, file bytes)

    def make_sources(self, n: int) -> None:
        for i in range(n):
            arr = images.scan(self.ctx.seed, i, self.h, self.w,
                              self.ctx.gen_device, self.components,
                              self.bitdepth)
            path = os.path.join(self.ctx.workdir, f"src-{i}.tif")
            images.write_tiff(path, arr)
            self.sources.append((path, arr))

    def landed(self, image_id: str) -> str | None:
        """The landed object of ``image_id``'s derivative, or None."""
        key = urllib.parse.quote(image_id, safe="") + ".jpx"
        path = os.path.join(self.engine.s3_client.root, BUCKET, key)
        return path if f"{BUCKET}/{key}" in self.engine.s3_client.metadata \
            and os.path.exists(path) else None

    def judge_objects(self, objects: list, rng, control: bool) -> dict:
        """Hold what landed, [(path, source index)], to the reference:
        code-blocks of a sample of the objects drawn from ``rng``
        (``check.blocks`` drawn in each, and every block of one tile of
        the first) and, where the recipe states a rate, every object's
        size (``rate_off``: the widest share by which a codestream
        misses rate x pixels / 8 bytes)."""
        chk = self.mix["check"]
        self.landed_bytes = [(self.pixels, self.components,
                              os.path.getsize(p)) for p, _ in objects]
        if not objects:
            return {}
        parts, why = [], []
        rate = self.config["recipe"].get("rate")
        if rate:
            target = rate * self.pixels / 8
            off = 0.0
            for path, _ in objects:
                with open(path, "rb") as fh:
                    try:
                        size = len(j2k.unbox(fh.read()))
                    except j2k.J2kError:
                        size = 0
                off = max(off, abs(size / target - 1))
            parts.append({"rate_off": off})
        pick = rng.choice(len(objects), min(chk["objects"], len(objects)),
                          replace=False)
        truths = {}
        for n, i in enumerate(sorted(int(k) for k in pick)):
            path, src = objects[i]
            truth = truths.setdefault(
                src, judge.Truth(self.sources[src][1], self.bitdepth))
            with open(path, "rb") as fh:
                data = fh.read()
            try:
                parts.append(judge.judge_file(
                    data, truth, rng, chk["blocks"],
                    self.config.get("quant_base_step"), control=control,
                    whole_tile=n == 0))
            except (j2k.J2kError, IndexError, KeyError, ValueError,
                    struct.error) as exc:
                parts.append({"unreadable": 1})
                why.append(str(exc))
        out = judge.combine(parts)
        if why:
            out["why"] = why
        return out
