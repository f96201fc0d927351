"""Feature flags.

Port of the reference's moirai-based flag system (reference:
src/main/java/edu/ucla/library/bucketeer/Features.java:10-16,
verticles/AbstractBucketeerVerticle.java:113-122). Flags are read from a
simple ``key = true|false`` conf file (HOCON-ish subset, same file syntax
the reference's /etc/bucketeer/bucketeer-features.conf uses) or from the
config/environment, and checked at runtime — never cached across checks,
matching moirai's dynamic reload semantics.
"""
from __future__ import annotations

import os
import re

LARGE_IMAGES = "bucketeer.large.images"
FS_WRITE_CSV = "bucketeer.fs.write.csv"

ALL_FLAGS = (LARGE_IMAGES, FS_WRITE_CSV)

DEFAULT_FLAGS_FILE = "/etc/bucketeer/bucketeer-features.conf"

_LINE = re.compile(r"^\s*([\w.\-]+)\s*[:=]\s*(true|false|on|off|yes|no|1|0)\s*,?\s*$", re.I)


class FeatureFlagChecker:
    """Dynamic flag checker; re-reads the conf file on every check."""

    def __init__(self, flags_file: str | None = None,
                 static: dict[str, bool] | None = None) -> None:
        self._file = flags_file if flags_file is not None else os.environ.get(
            "FEATURE_FLAGS_FILE", DEFAULT_FLAGS_FILE)
        self._static = dict(static or {})

    def is_enabled(self, flag: str) -> bool:
        if flag in self._static:
            return self._static[flag]
        env_key = flag.replace(".", "_").upper()
        if env_key in os.environ:
            return os.environ[env_key].lower() in ("true", "on", "yes", "1")
        return self._read_file().get(flag, False)

    def report(self) -> dict:
        """Per-flag booleans for /status (reference: GetStatusHandler.java:30-46)."""
        flags = {flag: self.is_enabled(flag) for flag in ALL_FLAGS}
        return {"enabled": any(flags.values()), **flags}

    def _read_file(self) -> dict[str, bool]:
        out: dict[str, bool] = {}
        if self._file and os.path.exists(self._file):
            with open(self._file, "r", encoding="utf-8") as fh:
                for line in fh:
                    m = _LINE.match(line)
                    if m:
                        out[m.group(1)] = m.group(2).lower() in ("true", "on", "yes", "1")
        return out
