"""conformance pass: registry, spec, and catalog invariants of the port.

Dynamic (import-the-port) checks, each on the port's own counterpart of
what the reference's pass reads:

1. every registered component factory's product satisfies its kind's
   protocol (class factories directly, function factories via their
   return annotation; un-annotated function factories are skipped);
2. every spec dataclass survives ``to_dict`` -> ``from_dict`` with dict
   equality, and ``from_dict`` rejects unknown keys;
3. every ``src/repro_torch/specs/*.json`` and every scenario-catalog
   pipeline resolves to registered components;
4. every ``src/repro_torch/experiments/*.py`` module is registered in
   ``experiments/run.py``'s MODULES table (checked statically so the
   experiment imports never run at lint time), and the required gate rows
   (``REQUIRED_BENCHMARKS``) are present;
5. the retrieve-backend ladder: the required vectordb backends
   (``REQUIRED_VECTORDB_BACKENDS``) are registered, the ``torch_fused``
   factory actually produces a fused-rung DB (a tiny one on the CPU: the
   check is of the rung, not of a kernel), and the ``use_kernel`` ladder
   rejects invalid rungs.
"""
from __future__ import annotations

import ast
import inspect
import os
import typing
from typing import Any, Dict, List, Tuple, Type

from repro_torch.analysis.core import Finding, SourceFile

PASS = "conformance"

#: kind -> methods its product must expose (callable attributes).
PROTOCOLS: Dict[str, Tuple[str, ...]] = {
    "embedder": ("embed",),
    "chunker": ("chunk",),
    "vectordb": ("insert", "remove", "search", "build_index",
                 "get_chunk", "get_chunks", "stats"),
    "reranker": ("rerank",),
    "llm": ("generate",),
}

#: vectordb backends every build must expose (the retrieve-backend ladder).
REQUIRED_VECTORDB_BACKENDS: Tuple[str, ...] = ("torch", "torch_sharded",
                                               "torch_fused")

#: benchmark gates that must stay in experiments/run.py MODULES even if the
#: module file itself were deleted (the generic file scan would then miss it).
REQUIRED_BENCHMARKS: Tuple[str, ...] = ("fused_retrieve",)

#: the port's spec files and experiment modules, relative to the repo root
SPECS_DIR = "src/repro_torch/specs"
EXPERIMENTS_DIR = "src/repro_torch/experiments"


def _locate(obj: Any, root: str) -> Tuple[str, int]:
    try:
        path = inspect.getsourcefile(obj) or ""
        _, line = inspect.getsourcelines(obj)
    except (OSError, TypeError):
        return "<unknown>", 1
    rel = os.path.relpath(path, root)
    if rel.startswith(".."):
        rel = os.path.basename(path)
    return rel.replace(os.sep, "/"), line


def _protocol_findings(root: str) -> List[Finding]:
    from repro_torch.core import registry
    out: List[Finding] = []
    for kind, methods in PROTOCOLS.items():
        for name in registry.available(kind):
            factory = registry.get_factory(kind, name)
            if inspect.isclass(factory):
                target: Any = factory
            else:
                try:
                    hints = typing.get_type_hints(factory)
                except Exception:
                    hints = {}
                ret = hints.get("return")
                target = ret if inspect.isclass(ret) else None
            if target is None:
                continue  # opaque function factory: nothing to check
            path, line = _locate(factory, root)
            for m in methods:
                if not callable(getattr(target, m, None)):
                    out.append(Finding(
                        PASS, path, line,
                        f"{kind} component '{name}' ({target.__name__}) "
                        f"lacks protocol method {m}()"))
    return out


def check_spec_roundtrip(cls: Type, kwargs: Dict[str, Any],
                         root: str = "") -> List[Finding]:
    """Reusable probe: ``cls(**kwargs)`` must survive
    ``from_dict(to_dict())`` with dict equality and ``from_dict`` must
    reject an unknown key with ValueError/TypeError."""
    path, line = _locate(cls, root or os.getcwd())
    out: List[Finding] = []
    obj = cls(**kwargs)
    d = obj.to_dict()
    try:
        again = cls.from_dict(d).to_dict()
    except Exception as e:  # noqa: BLE001 -- any failure is the finding
        out.append(Finding(PASS, path, line,
                           f"{cls.__name__}.from_dict(to_dict()) raised "
                           f"{type(e).__name__}: {e}"))
        return out
    if again != d:
        out.append(Finding(PASS, path, line,
                           f"{cls.__name__} does not round-trip through "
                           f"to_dict/from_dict"))
    probe = dict(d)
    probe["__conformance_probe__"] = 1
    try:
        cls.from_dict(probe)
    except (ValueError, TypeError):
        pass
    else:
        out.append(Finding(PASS, path, line,
                           f"{cls.__name__}.from_dict accepts unknown keys "
                           f"(no unknown-key rejection)"))
    return out


def _spec_findings(root: str) -> List[Finding]:
    from repro_torch.core.spec import (AutoscaleSpec, GenSpec, PipelineSpec,
                                       StageSpec)
    from repro_torch.scenarios.spec import ArrivalSpec, MixSpec, ScenarioSpec
    from repro_torch.serving.faults import FaultEvent, FaultSpec
    cases: List[Tuple[Type, Dict[str, Any]]] = [
        (PipelineSpec, {}),
        (StageSpec, {"component": "hash"}),
        (GenSpec, {}),
        (AutoscaleSpec, {}),
        (ArrivalSpec, {}),
        (MixSpec, {}),
        (ScenarioSpec, {"name": "conformance-probe"}),
        (FaultEvent, {"t_s": 0.0, "kind": "writer_stall"}),
        (FaultSpec, {}),
    ]
    out: List[Finding] = []
    for cls, kwargs in cases:
        out.extend(check_spec_roundtrip(cls, kwargs, root))
    return out


def _resolution_findings(root: str) -> List[Finding]:
    from repro_torch.core import registry
    from repro_torch.core.spec import COMPONENT_KINDS, PipelineSpec
    out: List[Finding] = []

    def _resolve_spec(spec: PipelineSpec, path: str, what: str) -> None:
        for kind in COMPONENT_KINDS:
            comp = spec.stage(kind).component
            try:
                registry.get_factory(kind, comp)
            except registry.RegistryError as e:
                out.append(Finding(
                    PASS, path, 1,
                    f"{what}: {kind} component {comp!r} does not "
                    f"resolve ({e.args[0] if e.args else e})"))

    specs_dir = os.path.join(root, SPECS_DIR)
    if os.path.isdir(specs_dir):
        for fn in sorted(os.listdir(specs_dir)):
            if not fn.endswith(".json"):
                continue
            rel = f"{SPECS_DIR}/{fn}"
            try:
                spec = PipelineSpec.from_file(os.path.join(specs_dir, fn))
            except (ValueError, KeyError, OSError) as e:
                out.append(Finding(PASS, rel, 1,
                                   f"spec file does not parse: {e}"))
                continue
            _resolve_spec(spec, rel, "example spec")

    from repro_torch.scenarios import registry as scen_registry
    cat_path, _ = _locate(scen_registry, root)
    for name in scen_registry.scenario_names():
        try:
            spec = scen_registry.get_scenario(name).pipeline_spec()
        except (ValueError, KeyError) as e:
            out.append(Finding(PASS, cat_path, 1,
                               f"scenario '{name}' pipeline_spec() "
                               f"failed: {e}"))
            continue
        _resolve_spec(spec, cat_path, f"scenario '{name}'")
    return out


def _benchmark_registration_findings(root: str) -> List[Finding]:
    bdir = os.path.join(root, EXPERIMENTS_DIR)
    run_py = os.path.join(bdir, "run.py")
    run_rel = f"{EXPERIMENTS_DIR}/run.py"
    if not os.path.isdir(bdir) or not os.path.exists(run_py):
        return []
    exempt = {"run", "common", "__init__"}
    modules = sorted(fn[:-3] for fn in os.listdir(bdir)
                     if fn.endswith(".py") and fn[:-3] not in exempt)
    with open(run_py, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=run_rel)
    registered: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            if any(isinstance(t, ast.Name) and t.id == "MODULES"
                   for t in node.targets):
                for k in node.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        registered.add(k.value)
    out: List[Finding] = []
    if not registered:
        out.append(Finding(PASS, run_rel, 1,
                           "could not locate the MODULES table"))
        return out
    for mod in modules:
        if mod not in registered:
            out.append(Finding(
                PASS, f"{EXPERIMENTS_DIR}/{mod}.py", 1,
                f"benchmark module '{mod}' is not registered in "
                f"{run_rel} MODULES"))
    for mod in REQUIRED_BENCHMARKS:
        if mod not in registered:
            out.append(Finding(
                PASS, run_rel, 1,
                f"required benchmark gate '{mod}' is missing from the "
                f"MODULES table"))
    return out


def _retrieve_backend_findings(root: str) -> List[Finding]:
    """The fused retrieve backend's registry/ladder invariants."""
    from repro_torch.core import registry
    from repro_torch.core import vectordb as vdb
    out: List[Finding] = []
    path, line = _locate(vdb.TorchVectorDB, root)
    available = set(registry.available("vectordb"))
    for name in REQUIRED_VECTORDB_BACKENDS:
        if name not in available:
            out.append(Finding(
                PASS, path, line,
                f"required vectordb backend '{name}' is not registered"))
    if "torch_fused" in available:
        # tiny instantiation: the factory must pin the fused rung
        db = registry.create("vectordb", "torch_fused", index_type="flat",
                             dim=8, capacity=64, nlist=4, flat_capacity=16,
                             device="cpu")
        if getattr(db, "_kernel", None) != "fused":
            out.append(Finding(
                PASS, path, line,
                "vectordb:torch_fused factory does not produce a fused-rung "
                f"DB (_kernel={getattr(db, '_kernel', None)!r})"))
    try:
        vdb.kernel_ladder("definitely-not-a-rung")
    except ValueError:
        pass
    else:
        out.append(Finding(
            PASS, path, line,
            "kernel_ladder() accepts invalid use_kernel values (no "
            "validation)"))
    return out


def run(files: List[SourceFile], root: str) -> List[Finding]:
    out: List[Finding] = []
    out.extend(_protocol_findings(root))
    out.extend(_spec_findings(root))
    out.extend(_resolution_findings(root))
    out.extend(_benchmark_registration_findings(root))
    out.extend(_retrieve_backend_findings(root))
    return out
