"""Component registry: uniform construction of pipeline components from
config (the pluggable-backend layer the paper's Fig. 4 interfaces imply).

Implementations self-register with a decorator::

    @register("embedder", "hash")
    class HashEmbedder(BaseEmbedder): ...

and are constructed uniformly by name::

    emb = create("embedder", "hash", dim=384)

``build(spec)`` is the single entry point that turns a declarative
``PipelineSpec`` into a live ``RAGPipeline``; third-party backends become
pluggable by registering under a new name and naming it in the spec — no
if/elif ladders anywhere.

Factories may declare *context* parameters (e.g. ``embedder`` for the
bi-encoder reranker, ``dim`` for the vector DB): ``create`` injects a context
value only when the factory signature names that parameter and the caller did
not supply it explicitly.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional

# kind -> name -> factory (class or function)
_REGISTRY: Dict[str, Dict[str, Callable]] = {}


class RegistryError(KeyError):
    """Unknown component name / kind (message lists what is available)."""


def register(kind: str, name: str) -> Callable:
    """Class/function decorator: register a component factory under
    ``(kind, name)``.  Duplicate names are an error — a plugin overriding a
    built-in silently would make specs ambiguous."""

    def deco(factory: Callable) -> Callable:
        table = _REGISTRY.setdefault(kind, {})
        if name in table:
            raise ValueError(
                f"duplicate {kind} component {name!r} "
                f"(already registered: {table[name]!r})")
        table[name] = factory
        return factory

    return deco


def _ensure_registered() -> None:
    """Import the built-in component modules so their ``@register``
    decorators have run (lazy to avoid import cycles)."""
    from repro_torch.core import chunking, embedder, generator, reranker, vectordb  # noqa: F401
    from repro_torch.serving import genengine  # noqa: F401  (llm: model_engine)
    from repro_torch.sharded import vectordb as sharded_vectordb  # noqa: F401


def available(kind: Optional[str] = None) -> List[str]:
    _ensure_registered()
    if kind is None:
        return sorted(_REGISTRY)
    return sorted(_REGISTRY.get(kind, {}))


def get_factory(kind: str, name: str) -> Callable:
    _ensure_registered()
    table = _REGISTRY.get(kind)
    if table is None:
        raise RegistryError(
            f"unknown component kind {kind!r}; kinds: {sorted(_REGISTRY)}")
    if name not in table:
        raise RegistryError(
            f"unknown {kind} component {name!r}; "
            f"available: {sorted(table)}")
    return table[name]


def create(kind: str, name: str, _context: Optional[Dict[str, Any]] = None,
           **options) -> Any:
    """Construct component ``(kind, name)`` with ``options`` kwargs.

    ``_context`` values are injected only for parameters the factory
    explicitly names (never through ``**kwargs``) and never override an
    explicit option.
    """
    factory = get_factory(kind, name)
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        params = None
    if _context and params is not None:
        for key, val in _context.items():
            if key in params and key not in options:
                options[key] = val
    if params is not None:
        # Surface construction mistakes as registry errors naming the
        # component and the offending key, instead of the raw TypeError
        # from the factory's Python signature.
        has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in params.values())
        if not has_var_kw:
            unexpected = sorted(k for k in options if k not in params)
            if unexpected:
                raise RegistryError(
                    f"cannot construct {kind} component {name!r}: "
                    f"unexpected option(s) {unexpected}; accepted: "
                    f"{sorted(k for k in params if k != 'self')}")
        missing = sorted(
            pname for pname, p in params.items()
            if pname not in options and pname != "self"
            and p.default is inspect.Parameter.empty
            and p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                           inspect.Parameter.KEYWORD_ONLY))
        if missing:
            raise RegistryError(
                f"cannot construct {kind} component {name!r}: missing "
                f"required argument(s) {missing}; pass them as options or "
                f"provide a _context entry with that key")
    return factory(**options)


def build(spec, **component_overrides):
    """Build a ``RAGPipeline`` from a declarative ``PipelineSpec``.

    ``component_overrides`` (``embedder=`` / ``db=`` / ``reranker=`` /
    ``llm=``) substitute pre-built instances for the corresponding spec slot
    — the escape hatch benchmarks use to share one expensive model across
    pipelines.
    """
    from repro_torch.core.pipeline import RAGPipeline
    return RAGPipeline.from_spec(spec, **component_overrides)
