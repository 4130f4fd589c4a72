"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

A workload entry names its configuration (``ragbench/configs/<config>.json``,
through the manifest's ``configs`` entry) and its traffic mix
(``ragbench/mixes/<traffic>.json``); the limits of its correctness check are
``ragbench/limits/<workload>.json``. ``tiny=True`` merges each file's
``tiny`` block over it: the sizes the CPU tests run at.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` with ``over``'s keys laid over it, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    return read_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    cfg: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, Any]
    tiny: bool = False
    per_layer: List[Dict[str, Any]] = field(default_factory=list)
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)

    def metric_names(self, trace: bool) -> List[str]:
        """The metrics this cell reports: its end-to-end metrics with
        ``trace`` off, its per-layer metrics with it on."""
        entries = self.per_layer if trace else self.end_to_end
        return [m["name"] for m in entries
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str, tiny: bool = False, root: Path = ROOT) -> Cell:
    """The workload ``name`` of the manifest, with its files."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    cfg = read_json(root / conf["file"])
    mix = read_json(HERE / "mixes" / f"{entry['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{name}.json")
    if tiny:
        cfg = merge(cfg, cfg.get("tiny", {}))
        mix = merge(mix, mix.get("tiny", {}))
    return Cell(name=name, config_name=entry["config"],
                traffic=entry["traffic"], chips=int(entry["chips"]), cfg=cfg,
                mix=mix, limits=limits, tiny=tiny,
                per_layer=man["per_layer"], end_to_end=man["end_to_end"])
