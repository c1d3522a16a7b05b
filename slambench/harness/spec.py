"""Find a cell's files by the names in BENCHMARK.json.

A cell `<config>.<traffic>` reads
  slambench/configs/<config>.json   the configuration as it is run,
  slambench/traffic/<traffic>.json  the scene and camera path (data),
  slambench/cells/<cell>.json       frame counts and the correctness limits,
and each per-layer metric `<name>` is read by slambench/metrics/<name>.py,
whose `read(summary)` returns a number or None. A cell or a metric is added
by adding files and BENCHMARK.json entries; nothing here names one.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of BENCHMARK.json with its files loaded."""

    def __init__(self, bench: dict, name: str, bench_dir: str = BENCH_DIR):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(entries)})")
        self.entry = entries[name]
        self.name = name
        self.bench = bench
        self.dir = bench_dir
        cfg_entry = {c["name"]: c for c in bench["configs"]}[
            self.entry["config"]]
        self.config = _json(os.path.join(os.path.dirname(bench_dir),
                                         cfg_entry["file"]))
        self.traffic = _json(os.path.join(
            bench_dir, "traffic", self.entry["traffic"] + ".json"))
        self.spec = _json(os.path.join(bench_dir, "cells", name + ".json"))

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """Per-layer metrics read in this cell: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def run_config(self) -> tuple:
        """(the configuration as this cell runs it, frame count)."""
        return apply_traffic(self.config, self.traffic,
                             int(self.spec["n_frames"]))


def apply_traffic(config: dict, traffic: dict, n_frames: int) -> tuple:
    """The general generator of the traffic files: the scene named by
    `dataset`, its `synthetic` parameters, and the camera path's length.
    An orbit (`degrees_per_frame`) sweeps that many degrees a frame over
    n_frames frames; a walk keeps its own frame count, which is its speed.
    Returns (config, frames)."""
    cfg = copy.deepcopy(config)
    cfg["dataset"] = traffic["dataset"]
    syn = cfg["data"]["synthetic"]
    syn.update(copy.deepcopy(traffic.get("synthetic", {})))
    if "degrees_per_frame" in traffic:
        syn["n_frames"] = n_frames
        syn["orbit_degrees"] = float(traffic["degrees_per_frame"]) * n_frames
    elif int(syn["n_frames"]) != n_frames:
        raise ValueError(f"the walk has {syn['n_frames']} frames, the cell "
                         f"asks for {n_frames}")
    return cfg, n_frames


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The `read(summary)` function of slambench/metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
