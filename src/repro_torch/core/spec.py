"""Declarative pipeline specification (the stage-graph API).

A ``PipelineSpec`` fully describes a RAG pipeline as data: one ``StageSpec``
per component slot (embedder / chunker / vectordb / reranker / llm) naming a
registered component plus its constructor options, and the pipeline-level
retrieval depths.  Specs round-trip losslessly through dict/JSON, so a
pipeline is reproducible from a config file alone::

    spec = PipelineSpec.from_file("src/repro_torch/specs/fused_ivf.json")
    pipe = repro_torch.core.registry.build(spec)

Stage ``replicas`` and the ``autoscale`` block drive the elastic executor
(``repro_torch.serving``). The JAX package's spec format also carries a
``gen`` block, for the token-level engine the port does not have yet:
``from_dict`` reads it only at its off value (``enabled: false``) and raises
naming the ROADMAP.md item otherwise, so a spec is never served by a path
other than the one it asks for.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

# the component slots a pipeline is assembled from, in stage-graph order
COMPONENT_KINDS = ("embedder", "chunker", "vectordb", "reranker", "llm")

# component slot -> query-path stage name (the chunker has no query stage)
QUERY_STAGE_NAMES = {"embedder": "query_embed", "vectordb": "retrieval",
                     "reranker": "rerank", "llm": "generation"}

# keys of the JAX package's spec format for serving features not ported
# yet -> the item of ROADMAP.md queue 1 that ports them
NOT_PORTED = {
    "gen": "queue 1 item 8 (the token-level engine)",
}


def _not_ported(key: str, value: Any) -> NotImplementedError:
    return NotImplementedError(
        f"spec key {key!r} = {value!r} is not ported yet: ROADMAP.md "
        f"{NOT_PORTED[key]}")


@dataclass
class StageSpec:
    """One component slot: registry name + constructor kwargs.

    ``batch_size`` is the stage-level micro-batch used by the pipelined
    executor (0 means "inherit the executor default"); the lock-step path
    ignores it.  ``replicas`` is the *initial* worker-pool width the elastic
    executor runs for this stage (the autoscaler may grow/shrink it at
    runtime); the single-worker ``StagedExecutor`` and the lock-step path
    ignore it.
    """

    component: str
    options: Dict[str, Any] = field(default_factory=dict)
    batch_size: int = 0
    replicas: int = 1

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1: {self.replicas}")

    def to_dict(self) -> Dict[str, Any]:
        return {"component": self.component, "options": dict(self.options),
                "batch_size": self.batch_size, "replicas": self.replicas}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StageSpec":
        unknown = set(d) - {"component", "options", "batch_size", "replicas"}
        if unknown:
            raise ValueError(f"unknown StageSpec keys: {sorted(unknown)}")
        if "component" not in d:
            raise ValueError(f"StageSpec needs a 'component' name, got {d!r}")
        return cls(component=str(d["component"]),
                   options=dict(d.get("options", {})),
                   batch_size=int(d.get("batch_size", 0)),
                   replicas=int(d.get("replicas", 1)))


@dataclass
class AutoscaleSpec:
    """Controller settings for elastic serving
    (``repro_torch.serving.autoscale``).

    ``ladder`` is the quality ladder the controller walks under SLO
    pressure: ``[[nprobe, rerank_k], ...]`` from the configured quality
    (step 0) down to the cheapest acceptable setting.  Empty means "derive a
    default ladder from the pipeline's configured knobs".
    """

    enabled: bool = False
    max_replicas: int = 4
    interval_ms: float = 200.0
    slo_ms: float = 500.0
    max_batch: int = 64                 # batch-size autoscaling ceiling
    ladder: List[List[int]] = field(default_factory=list)

    _KEYS = ("enabled", "max_replicas", "interval_ms", "slo_ms", "max_batch",
             "ladder")

    def to_dict(self) -> Dict[str, Any]:
        return {"enabled": self.enabled, "max_replicas": self.max_replicas,
                "interval_ms": self.interval_ms, "slo_ms": self.slo_ms,
                "max_batch": self.max_batch,
                "ladder": [list(step) for step in self.ladder]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AutoscaleSpec":
        unknown = set(d) - set(cls._KEYS)
        if unknown:
            raise ValueError(f"unknown AutoscaleSpec keys: {sorted(unknown)}")
        return cls(enabled=bool(d.get("enabled", False)),
                   max_replicas=int(d.get("max_replicas", 4)),
                   interval_ms=float(d.get("interval_ms", 200.0)),
                   slo_ms=float(d.get("slo_ms", 500.0)),
                   max_batch=int(d.get("max_batch", 64)),
                   ladder=[[int(x) for x in step]
                           for step in d.get("ladder", [])])


@dataclass
class PipelineSpec:
    """The full stage graph: five component slots + retrieval depths."""

    embedder: StageSpec = field(
        default_factory=lambda: StageSpec("hash", {"dim": 384}))
    chunker: StageSpec = field(
        default_factory=lambda: StageSpec("separator",
                                          {"size": 512, "overlap": 0}))
    vectordb: StageSpec = field(
        default_factory=lambda: StageSpec("torch", {"index_type": "ivf"}))
    reranker: StageSpec = field(
        default_factory=lambda: StageSpec("overlap"))
    llm: StageSpec = field(default_factory=lambda: StageSpec("extractive"))
    retrieve_k: int = 16          # initial retrieval depth
    rerank_k: int = 4             # context depth passed to generation
    autoscale: AutoscaleSpec = field(default_factory=AutoscaleSpec)

    def stage(self, kind: str) -> StageSpec:
        assert kind in COMPONENT_KINDS, kind
        return getattr(self, kind)

    def stage_replicas(self) -> Dict[str, int]:
        """Initial elastic replica count per query-path stage name."""
        return {name: self.stage(kind).replicas
                for kind, name in QUERY_STAGE_NAMES.items()}

    def stage_batch_sizes(self) -> Dict[str, int]:
        """Per-stage micro-batch overrides keyed by query-path stage name."""
        return {name: self.stage(kind).batch_size
                for kind, name in QUERY_STAGE_NAMES.items()}

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            **{k: self.stage(k).to_dict() for k in COMPONENT_KINDS},
            "retrieve_k": self.retrieve_k,
            "rerank_k": self.rerank_k,
            "autoscale": self.autoscale.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineSpec":
        unknown = (set(d) - set(COMPONENT_KINDS)
                   - {"retrieve_k", "rerank_k", "autoscale", "gen"})
        if unknown:
            raise ValueError(f"unknown PipelineSpec keys: {sorted(unknown)}")
        if dict(d.get("gen", {})).get("enabled", False):
            raise _not_ported("gen", d["gen"])
        kw: Dict[str, Any] = {}
        for kind in COMPONENT_KINDS:
            if kind in d:
                kw[kind] = StageSpec.from_dict(d[kind])
        if "retrieve_k" in d:
            kw["retrieve_k"] = int(d["retrieve_k"])
        if "rerank_k" in d:
            kw["rerank_k"] = int(d["rerank_k"])
        if "autoscale" in d:
            kw["autoscale"] = AutoscaleSpec.from_dict(d["autoscale"])
        return cls(**kw)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PipelineSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "PipelineSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def merged(self, overrides: Dict[str, Any]) -> "PipelineSpec":
        """Apply a *partial* spec dict on top of this spec (deep merge).

        Component-slot entries merge key-wise — their ``options`` dicts merge
        rather than replace, so an override like
        ``{"vectordb": {"options": {"nprobe": 4}}}`` retunes one knob without
        restating the component.  Scenario specs use this to carry pipeline
        deltas instead of full pipeline copies.
        """
        base = self.to_dict()
        for key, val in overrides.items():
            if key in COMPONENT_KINDS and isinstance(val, dict):
                slot = dict(base[key])
                opts = {**slot.get("options", {}), **val.get("options", {})}
                slot.update(val)
                slot["options"] = opts
                base[key] = slot
            else:
                base[key] = val
        return PipelineSpec.from_dict(base)
