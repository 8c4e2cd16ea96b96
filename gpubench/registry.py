"""Finds what ``BENCHMARK.json`` names, by name, as files of their own:

  configs/<config>.json     a configuration: published widths, weights,
                            engine options
  traffic/<mix>.json        a traffic mix: its loop and parameters
  limits/<workload>.json    a cell's correctness limits and their readings
  metrics/<metric>.py       a per-layer metric's reader
  archs/<architecture>.py   an architecture: its weights' draw, its model
                            file and its plain reference

A later change adds a configuration, a mix, a cell, a metric or an
architecture by adding files and entries; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(PKG)


class Registry:
    def __init__(self, root: str = PKG):
        self.root = root

    def _json(self, kind: str, name: str) -> dict:
        path = os.path.join(self.root, kind, f"{name}.json")
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def _module(self, kind: str, name: str):
        path = os.path.join(self.root, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"gpubench_{kind}_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def metric(self, name: str):
        """The reader module of a per-layer metric (``read(ctx)``)."""
        return self._module("metrics", name)

    def arch(self, name: str):
        """The module of an architecture: ``draw(cfg, seed, device)``, the
        weights; ``write(directory, cfg, vocab, weights) -> (path, bytes)``,
        what ``BertTorch.from_file`` loads (a file or a checkpoint
        directory); ``Reference(weights, cfg, device, precision)`` with
        ``embed(token_lists)``, the plain reference (``precision`` "f32"
        or "fp8")."""
        return self._module("archs", name)


def load_benchmark(path: str = os.path.join(CHECKOUT, "BENCHMARK.json")
                   ) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(entries, cell: dict, reported=None):
    """The entries that apply to ``cell``: those that list it, and those
    with no list; a per-layer metric without a list applies where its
    ``moves`` metric is ``reported``."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out
