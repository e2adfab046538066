"""Find everything a cell needs by the names in BENCHMARK.json.

    cell (workloads[].name)  -> its configuration and traffic names
    configuration            -> configs[].file (JSON), whose "generator"
                                names proofbench/circuits/<generator>.py
    traffic                  -> proofbench/traffic/<traffic>.json
    end-to-end metric        -> proofbench/end_to_end/<name>.py
    per-layer metric         -> proofbench/layers/<name>.py

A metric module defines `read(ctx)`, which returns a number, or None where
the run gave it nothing to read (the harness then leaves it out).  A later
cell, configuration, traffic mix or metric is a new file and a new entry,
with no edit to a file that is here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass, field

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    read: object                      # read(ctx) -> number or None
    layer: str = ""
    moves: str = ""


@dataclass
class Plan:
    cell: str
    chips: int
    config: dict
    traffic: dict
    generator: object                 # module with build(cfg), witness(circuit, cfg, rng)
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _load(path: str, label: str):
    """A metric's module by its file path (its name may hold dots)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{label}: no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        "proofbench_metric_" + re.sub(r"\W", "_", os.path.relpath(path, PKG)), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise ValueError(f"{label}: {os.path.relpath(path, ROOT)} defines no read(ctx)")
    return mod.read


def _named(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, cell_e2e: set) -> bool:
    """A metric with `workloads` applies to the cells it lists; a per-layer
    one without them to every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in cell_e2e


def resolve(cell: str, root: str = ROOT) -> Plan:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    pkg = os.path.join(root, "proofbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[_named(w["config"], "config")]
    config = _json(os.path.join(root, entry["file"]))
    gen = _named(config["generator"], "generator")
    gen_path = os.path.join(pkg, "circuits", gen + ".py")
    if not os.path.exists(gen_path):
        raise FileNotFoundError(f"config {entry['name']}: no generator {gen_path}")
    spec = importlib.util.spec_from_file_location(f"proofbench.circuits.{gen}", gen_path)
    generator = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(generator)
    traffic = _json(os.path.join(pkg, "traffic", _named(w["traffic"], "traffic") + ".json"))

    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, set())]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"] if _applies(m, cell, names)]
    return Plan(
        cell=cell, chips=int(w["chips"]), config=config, traffic=traffic, generator=generator,
        end_to_end=[Metric(m["name"], m["unit"], m["better"],
                           _load(os.path.join(pkg, "end_to_end", _named(m["name"], "metric") + ".py"),
                                 m["name"])) for m in e2e],
        per_layer=[Metric(m["name"], m["unit"], m["better"],
                          _load(os.path.join(pkg, "layers", _named(m["name"], "metric") + ".py"),
                                m["name"]), m["layer"], m["moves"]) for m in layers])
