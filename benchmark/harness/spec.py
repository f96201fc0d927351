"""BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix, kind of
traffic or metric is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``kinds/<kind>.py``
and ``metrics/<metric>.py`` under this folder. A cell, a mix, a kind or
a metric is added by adding files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
KIND = re.compile(r"[a-z][a-z0-9_]{0,63}\Z")


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def workload(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, base: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} has characters a name "
                         "may not have")
    with open(os.path.join(base, kind, name + ".json"),
              encoding="utf-8") as fh:
        return json.load(fh)


def config(name: str, base: str = HERE) -> dict:
    return _json("configs", name, base)


def traffic(name: str, base: str = HERE) -> dict:
    return _json("traffic", name, base)


def metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    with ``trace`` off, the per-layer ones with it on; an entry with a
    ``workloads`` list applies to those cells only."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def _module(kind: str, name: str, base: str):
    path = os.path.join(base, kind, name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: str = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"metric name {name!r}")
    return _module("metrics", name, base).read


def kind(name: str, base: str = HERE):
    """The class ``Kind`` of ``kinds/<name>.py``: the code that drives
    and judges the mixes of that kind."""
    if not KIND.match(name):
        raise ValueError(f"kind name {name!r}")
    return _module("kinds", name, base).Kind


def names_ok(spec: dict) -> list:
    """Every name and unit of ``spec`` that breaks the character rules."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec.get(group, []):
            for key in ("name", "config", "traffic"):
                if key in entry and not NAME.match(entry[key]):
                    bad.append(f"{group}.{key}={entry[key]!r}")
            if "unit" in entry and not UNIT.match(entry["unit"]):
                bad.append(f"{group}.unit={entry['unit']!r}")
            for key in entry.get("reduced", []):
                if not NAME.match(key):
                    bad.append(f"{group}.reduced={key!r}")
    return bad
