"""Declarative benchmark scenarios (the workload half of the spec story).

A ``ScenarioSpec`` fully describes one serving scenario as data: the arrival
process (open/closed loop, Poisson / bursty / uniform / diurnal, offered
load), the read/write operation mix and document-access distribution, corpus
and stream sizes, the latency SLO, the autoscale block (reused verbatim from
``PipelineSpec.autoscale``), optional pipeline overrides, and the seed.  Specs
round-trip losslessly through dict/JSON exactly like ``PipelineSpec``, so a
scenario is reproducible from a config file alone — and because every field
that feeds randomness is seeded, a scenario doubles as a regression fixture
(the deterministic ``simulate()`` of ``repro_torch.scenarios.runner``).

``ScenarioSpec`` deliberately does not duplicate runtime config types: it
*maps onto* ``ArrivalConfig`` / ``WorkloadConfig`` / ``AutoscaleSpec``
(``arrival_config()`` / ``workload_config()``), so the serving layer keeps a
single source of truth for semantics.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict

from repro_torch.core.spec import AutoscaleSpec, PipelineSpec, StageSpec
from repro_torch.serving.arrival import ArrivalConfig
from repro_torch.serving.faults import FaultSpec
from repro_torch.workload.generator import WorkloadConfig


@dataclass
class ArrivalSpec:
    """Arrival-process block; field semantics match ``ArrivalConfig``."""

    mode: str = "open"              # open | closed
    process: str = "poisson"        # poisson | bursty | uniform | diurnal
    target_qps: float = 20.0
    concurrency: int = 4            # closed-loop in-flight cap
    burst_cycle_s: float = 2.0
    burst_duty: float = 0.25
    ramp_period_s: float = 8.0
    ramp_amplitude: float = 0.8

    _KEYS = ("mode", "process", "target_qps", "concurrency", "burst_cycle_s",
             "burst_duty", "ramp_period_s", "ramp_amplitude")

    def __post_init__(self):
        # delegate validation to the runtime config (one rule set)
        self.config(n_requests=1, seed=0)

    def config(self, n_requests: int, seed: int) -> ArrivalConfig:
        return ArrivalConfig(
            mode=self.mode, process=self.process, target_qps=self.target_qps,
            n_requests=n_requests, concurrency=self.concurrency,
            burst_cycle_s=self.burst_cycle_s, burst_duty=self.burst_duty,
            ramp_period_s=self.ramp_period_s,
            ramp_amplitude=self.ramp_amplitude, seed=seed)

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._KEYS}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ArrivalSpec":
        unknown = set(d) - set(cls._KEYS)
        if unknown:
            raise ValueError(f"unknown ArrivalSpec keys: {sorted(unknown)}")
        return cls(**{k: d[k] for k in cls._KEYS if k in d})


@dataclass
class MixSpec:
    """Operation mix + document-access distribution (``WorkloadConfig``)."""

    query_frac: float = 0.9
    insert_frac: float = 0.0
    update_frac: float = 0.1
    removal_frac: float = 0.0
    distribution: str = "uniform"   # uniform | zipfian
    zipf_s: float = 1.2

    _KEYS = ("query_frac", "insert_frac", "update_frac", "removal_frac",
             "distribution", "zipf_s")

    def __post_init__(self):
        self.config(n_requests=1, seed=0)

    def config(self, n_requests: int, seed: int) -> WorkloadConfig:
        return WorkloadConfig(
            query_frac=self.query_frac, insert_frac=self.insert_frac,
            update_frac=self.update_frac, removal_frac=self.removal_frac,
            distribution=self.distribution, zipf_s=self.zipf_s,
            n_requests=n_requests, seed=seed)

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._KEYS}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MixSpec":
        unknown = set(d) - set(cls._KEYS)
        if unknown:
            raise ValueError(f"unknown MixSpec keys: {sorted(unknown)}")
        return cls(**{k: d[k] for k in cls._KEYS if k in d})


# the default pipeline a scenario runs against (serving-scale IVF + the
# deterministic hash/extractive components; ``pipeline`` overrides deltas);
# ``torch`` is the twin of the reference's ``jax`` DB
def _base_pipeline_spec() -> PipelineSpec:
    return PipelineSpec(
        vectordb=StageSpec("torch", {"index_type": "ivf", "nlist": 16,
                                   "nprobe": 8, "capacity": 2048,
                                   "flat_capacity": 64}),
        retrieve_k=8, rerank_k=3)


@dataclass
class ScenarioSpec:
    """One named, seeded, fully-declarative serving scenario."""

    name: str
    description: str = ""
    arrival: ArrivalSpec = field(default_factory=ArrivalSpec)
    mix: MixSpec = field(default_factory=MixSpec)
    n_docs: int = 64
    n_requests: int = 200
    slo_ms: float = 150.0
    priority: str = "fifo"          # batcher read/write policy (live runs)
    seed: int = 0
    autoscale: AutoscaleSpec = field(default_factory=AutoscaleSpec)
    faults: FaultSpec = field(default_factory=FaultSpec)    # chaos block
    pipeline: Dict[str, Any] = field(default_factory=dict)  # spec overrides

    _KEYS = ("name", "description", "arrival", "mix", "n_docs", "n_requests",
             "slo_ms", "priority", "seed", "autoscale", "faults", "pipeline")

    def __post_init__(self):
        assert self.name, "a scenario needs a name"
        assert self.n_docs >= 1 and self.n_requests >= 1
        assert self.slo_ms > 0.0
        assert self.priority in ("fifo", "query_first", "mutation_first")

    # -- runtime-config mapping ---------------------------------------------

    def arrival_config(self, n_requests: int = 0) -> ArrivalConfig:
        return self.arrival.config(n_requests or self.n_requests, self.seed)

    def workload_config(self, n_requests: int = 0) -> WorkloadConfig:
        return self.mix.config(n_requests or self.n_requests, self.seed)

    def pipeline_spec(self) -> PipelineSpec:
        return _base_pipeline_spec().merged(self.pipeline)

    def scaled(self, scale: float) -> "ScenarioSpec":
        """A size-scaled copy (corpus + stream length); everything else —
        rates, mixes, knobs, seed — is preserved so the dynamics survive."""
        return self.replace(n_docs=max(16, int(self.n_docs * scale)),
                            n_requests=max(32, int(self.n_requests * scale)))

    def replace(self, **kw) -> "ScenarioSpec":
        return dataclasses.replace(self, **kw)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "description": self.description,
            "arrival": self.arrival.to_dict(), "mix": self.mix.to_dict(),
            "n_docs": self.n_docs, "n_requests": self.n_requests,
            "slo_ms": self.slo_ms, "priority": self.priority,
            "seed": self.seed, "autoscale": self.autoscale.to_dict(),
            "faults": self.faults.to_dict(),
            "pipeline": json.loads(json.dumps(self.pipeline)),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        unknown = set(d) - set(cls._KEYS)
        if unknown:
            raise ValueError(f"unknown ScenarioSpec keys: {sorted(unknown)}")
        if "name" not in d:
            raise ValueError(f"ScenarioSpec needs a 'name', got {d!r}")
        kw: Dict[str, Any] = {"name": str(d["name"])}
        if "arrival" in d:
            kw["arrival"] = ArrivalSpec.from_dict(d["arrival"])
        if "mix" in d:
            kw["mix"] = MixSpec.from_dict(d["mix"])
        if "autoscale" in d:
            kw["autoscale"] = AutoscaleSpec.from_dict(d["autoscale"])
        if "faults" in d:
            kw["faults"] = FaultSpec.from_dict(d["faults"])
        for k in ("description", "priority"):
            if k in d:
                kw[k] = str(d[k])
        for k in ("n_docs", "n_requests", "seed"):
            if k in d:
                kw[k] = int(d[k])
        if "slo_ms" in d:
            kw["slo_ms"] = float(d["slo_ms"])
        if "pipeline" in d:
            kw["pipeline"] = dict(d["pipeline"])
        return cls(**kw)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "ScenarioSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
