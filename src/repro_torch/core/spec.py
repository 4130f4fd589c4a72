"""Declarative pipeline specification (the stage-graph API).

A ``PipelineSpec`` fully describes a RAG pipeline as data: one ``StageSpec``
per component slot (embedder / chunker / vectordb / reranker / llm) naming a
registered component plus its constructor options, and the pipeline-level
retrieval depths.  Specs round-trip losslessly through dict/JSON, so a
pipeline is reproducible from a config file alone::

    spec = PipelineSpec.from_file("src/repro_torch/specs/fused_ivf.json")
    pipe = repro_torch.core.registry.build(spec)

The JAX package's spec format also carries stage ``replicas`` and the
``autoscale`` and ``gen`` blocks, for serving features the port does not
have yet. ``from_dict`` reads them only at their off values (one replica,
``enabled: false``) and raises naming the ROADMAP.md item otherwise, so a
spec is never served by a path other than the one it asks for.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict

# the component slots a pipeline is assembled from, in stage-graph order
COMPONENT_KINDS = ("embedder", "chunker", "vectordb", "reranker", "llm")

# component slot -> query-path stage name (the chunker has no query stage)
QUERY_STAGE_NAMES = {"embedder": "query_embed", "vectordb": "retrieval",
                     "reranker": "rerank", "llm": "generation"}

# keys of the JAX package's spec format for serving features not ported
# yet -> the item of ROADMAP.md queue 1 that ports them
NOT_PORTED = {
    "replicas": "queue 1 item 5 (elastic executors and autoscale)",
    "autoscale": "queue 1 item 5 (elastic executors and autoscale)",
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
    ignores it.
    """

    component: str
    options: Dict[str, Any] = field(default_factory=dict)
    batch_size: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"component": self.component, "options": dict(self.options),
                "batch_size": self.batch_size}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StageSpec":
        unknown = set(d) - {"component", "options", "batch_size", "replicas"}
        if unknown:
            raise ValueError(f"unknown StageSpec keys: {sorted(unknown)}")
        if "component" not in d:
            raise ValueError(f"StageSpec needs a 'component' name, got {d!r}")
        if int(d.get("replicas", 1)) != 1:
            raise _not_ported("replicas", d["replicas"])
        return cls(component=str(d["component"]),
                   options=dict(d.get("options", {})),
                   batch_size=int(d.get("batch_size", 0)))


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

    def stage(self, kind: str) -> StageSpec:
        assert kind in COMPONENT_KINDS, kind
        return getattr(self, kind)

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
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineSpec":
        unknown = (set(d) - set(COMPONENT_KINDS)
                   - {"retrieve_k", "rerank_k", "autoscale", "gen"})
        if unknown:
            raise ValueError(f"unknown PipelineSpec keys: {sorted(unknown)}")
        for key in ("autoscale", "gen"):
            if dict(d.get(key, {})).get("enabled", False):
                raise _not_ported(key, d[key])
        kw: Dict[str, Any] = {}
        for kind in COMPONENT_KINDS:
            if kind in d:
                kw[kind] = StageSpec.from_dict(d[kind])
        if "retrieve_k" in d:
            kw["retrieve_k"] = int(d["retrieve_k"])
        if "rerank_k" in d:
            kw["rerank_k"] = int(d["rerank_k"])
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
