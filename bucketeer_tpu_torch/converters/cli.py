"""CLI converters wrapping external JPEG 2000 encoders when installed.

Port of the reference's Kakadu/OpenJPEG converters (reference:
converters/KakaduConverter.java:36-77, OpenJPEGConverter.java:12-25 — the
latter is an unfinished stub there; here it works). Used as a
correctness oracle in tests and a no-TPU fallback, inverting the
reference's arrangement where the CLI was the primary path.
"""
from __future__ import annotations

import os
import shutil
import subprocess

from .base import Conversion, ConverterError, output_path


class CliConverter:
    """Base for subprocess-driven converters (reference:
    AbstractConverter.java:29-39 — run, wait, stderr -> exception)."""

    name = "CLI"
    executable = ""

    def _run(self, command: list[str]) -> None:
        proc = subprocess.run(command, capture_output=True, text=True)
        if proc.returncode != 0:
            raise ConverterError(
                f"{self.executable} failed ({proc.returncode}): "
                f"{proc.stderr.strip() or proc.stdout.strip()}")

    @classmethod
    def find_executable(cls) -> str | None:
        """Probe PATH (and KAKADU_HOME for kdu) the way the factory probes
        ``kdu_compress -v`` (reference: ConverterFactory.java:86-103)."""
        path = shutil.which(cls.executable)
        if path:
            return path
        home = os.environ.get("KAKADU_HOME")
        if home:
            candidate = os.path.join(home, cls.executable)
            if os.path.exists(candidate):
                return candidate
        return None

    @classmethod
    def is_available(cls) -> bool:
        return cls.find_executable() is not None


class KakaduConverter(CliConverter):
    """``kdu_compress`` with the reference's exact recipe (reference:
    KakaduConverter.java:38-44)."""

    name = "Kakadu"
    executable = "kdu_compress"

    BASE_OPTIONS = [
        "Clevels=6", "Clayers=6",
        "Cprecincts={256,256},{256,256},{128,128}",
        "Stiles={512,512}", "Corder=RPCL", "ORGgen_plt=yes", "ORGtparts=R",
        "Cblk={64,64}", "Cuse_sop=yes", "Cuse_eph=yes",
        "-flush_period", "1024",
    ]

    def convert(self, image_id: str, source_path: str,
                conversion: Conversion = Conversion.LOSSLESS) -> str:
        exe = self.find_executable()
        if exe is None:
            raise ConverterError("kdu_compress not found")
        dest = output_path(image_id, ".jpx")
        cmd = [exe, "-i", source_path, "-o", dest] + self.BASE_OPTIONS
        if conversion == Conversion.LOSSLESS:
            cmd += ["Creversible=yes", "-rate", "-"]
        else:
            cmd += ["-rate", "3"]
        self._run(cmd)
        return dest


class OpenJPEGConverter(CliConverter):
    """``opj_compress`` — complete here, unlike the reference's stub
    (reference: OpenJPEGConverter.java:22-25 returns null)."""

    name = "OpenJPEG"
    executable = "opj_compress"

    def convert(self, image_id: str, source_path: str,
                conversion: Conversion = Conversion.LOSSLESS) -> str:
        exe = self.find_executable()
        if exe is None:
            raise ConverterError("opj_compress not found")
        dest = output_path(image_id, ".jp2")
        cmd = [exe, "-i", source_path, "-o", dest, "-n", "7",
               "-b", "64,64", "-t", "512,512"]
        if conversion == Conversion.LOSSY:
            cmd += ["-r", "8"]   # ~3bpp on 24bpp input
        self._run(cmd)
        return dest
