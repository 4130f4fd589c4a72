"""Named scenario catalog (ROADMAP: burst/update-storm as first-class
benchmark modules).

Every registered scenario is a fully-declarative ``ScenarioSpec``:
reproducible from its seed, runnable live (``ScenarioRunner.serve``) or as a
wall-clock-free deterministic replay (``ScenarioRunner.simulate``).  The
catalog is the reference's (``repro.scenarios.registry``), so
``--scenario list`` reads the same in both packages; ``shard_scale`` runs
the port's sharded DB, ``torch_sharded`` (the reference's ``sharded``).
``get_scenario`` returns an isolated copy —
callers may mutate their spec freely without corrupting the catalog.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.spec import AutoscaleSpec
from repro_torch.serving.faults import FaultEvent, FaultSpec

from repro_torch.scenarios.spec import ArrivalSpec, MixSpec, ScenarioSpec

# the size the reference records its golden traces at
GOLDEN_SCALE = 0.5

_REGISTRY: Dict[str, ScenarioSpec] = {}


def register_scenario(spec: ScenarioSpec) -> ScenarioSpec:
    assert spec.name not in _REGISTRY, f"duplicate scenario {spec.name!r}"
    _REGISTRY[spec.name] = spec
    return spec


def scenario_names() -> List[str]:
    return sorted(_REGISTRY)


def get_scenario(name: str) -> ScenarioSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {scenario_names()}")
    # round-trip for isolation: registry entries must stay pristine
    return ScenarioSpec.from_dict(_REGISTRY[name].to_dict())


def golden_variant(name: str) -> ScenarioSpec:
    """The scaled-down, fixed-size variant the reference records its golden
    traces at."""
    return get_scenario(name).scaled(GOLDEN_SCALE)


_AUTOSCALE = AutoscaleSpec(enabled=True, max_replicas=4, interval_ms=100.0,
                           max_batch=8)

register_scenario(ScenarioSpec(
    name="steady",
    description="Steady-state Poisson queries at moderate load: the "
                "baseline regime — no bursts, no mutations, the controller "
                "should stay quiet.",
    arrival=ArrivalSpec(process="poisson", target_qps=40.0),
    mix=MixSpec(query_frac=1.0, update_frac=0.0),
    n_docs=64, n_requests=240, slo_ms=150.0, seed=0,
    autoscale=_AUTOSCALE))

register_scenario(ScenarioSpec(
    name="burst_tolerance",
    description="On/off bursts at ~7x the mean rate against a query-only "
                "stream: the elastic-scaling stressor (replica pools must "
                "absorb bursts, the quality ladder must recover in gaps).",
    arrival=ArrivalSpec(process="bursty", target_qps=80.0,
                        burst_cycle_s=1.0, burst_duty=0.15),
    mix=MixSpec(query_frac=1.0, update_frac=0.0),
    n_docs=48, n_requests=320, slo_ms=120.0, seed=0,
    autoscale=_AUTOSCALE))

register_scenario(ScenarioSpec(
    name="update_storm",
    description="Mutation-heavy zipfian stream (45% updates + inserts/"
                "removals) contending with reads: the serialized-writer and "
                "freshness stressor.",
    arrival=ArrivalSpec(process="poisson", target_qps=80.0),
    mix=MixSpec(query_frac=0.45, insert_frac=0.05, update_frac=0.45,
                removal_frac=0.05, distribution="zipfian"),
    n_docs=64, n_requests=320, slo_ms=200.0, priority="mutation_first",
    seed=0, autoscale=_AUTOSCALE))

register_scenario(ScenarioSpec(
    name="mixed_interference",
    description="Bursty reads over a 30% zipfian update stream: read/write "
                "interference under pressure — queries race hot-document "
                "updates for the same index.",
    arrival=ArrivalSpec(process="bursty", target_qps=130.0,
                        burst_cycle_s=1.0, burst_duty=0.3),
    mix=MixSpec(query_frac=0.7, update_frac=0.3, distribution="zipfian"),
    n_docs=64, n_requests=320, slo_ms=150.0, seed=0,
    autoscale=_AUTOSCALE))

# -- chaos scenarios (ROADMAP item 5: fault injection + recovery) ------------

register_scenario(ScenarioSpec(
    name="replica_failure",
    description="Two replica kills (retrieval, then generation) against a "
                "steady query stream with auto-respawn: in-flight batches "
                "must requeue within the retry budget and every request "
                "must reach a terminal state — the failure-isolation "
                "stressor.",
    arrival=ArrivalSpec(process="poisson", target_qps=60.0),
    mix=MixSpec(query_frac=1.0, update_frac=0.0),
    n_docs=48, n_requests=320, slo_ms=180.0, seed=0,
    autoscale=_AUTOSCALE,
    faults=FaultSpec(events=[
        # times tuned to land mid-batch at the golden_variant size, so the
        # recovery timeline exercises the requeue path, not just idle kills
        FaultEvent(t_s=0.504, kind="replica_kill", stage="retrieval"),
        FaultEvent(t_s=1.208, kind="replica_kill", stage="generation"),
    ], max_retries=2, respawn=True, respawn_delay_s=0.25),
    pipeline={"vectordb": {"replicas": 2}, "llm": {"replicas": 2}}))

register_scenario(ScenarioSpec(
    name="straggler_degrade",
    description="One retrieval replica turns 6x slow-straggler mid-run; "
                "per-replica service-time tracking must flag it so the "
                "controller retires and replaces it — the detection/"
                "recovery stressor.",
    arrival=ArrivalSpec(process="poisson", target_qps=60.0),
    mix=MixSpec(query_frac=1.0, update_frac=0.0),
    n_docs=48, n_requests=320, slo_ms=180.0, seed=0,
    autoscale=_AUTOSCALE,
    faults=FaultSpec(events=[
        FaultEvent(t_s=0.3, kind="replica_stall", stage="retrieval",
                   factor=6.0),
    ], detect=True, straggler_tolerance=1.5, straggler_window=16),
    pipeline={"vectordb": {"replicas": 2}}))

register_scenario(ScenarioSpec(
    name="writer_stall",
    description="The serialized mutation writer freezes for 1s under an "
                "update-heavy stream: mutations back up and must drain on "
                "resume while reads keep flowing — the write-path "
                "degradation stressor.",
    arrival=ArrivalSpec(process="poisson", target_qps=60.0),
    mix=MixSpec(query_frac=0.6, update_frac=0.4, distribution="zipfian"),
    n_docs=64, n_requests=240, slo_ms=200.0, priority="mutation_first",
    seed=0, autoscale=_AUTOSCALE,
    faults=FaultSpec(events=[
        FaultEvent(t_s=0.5, kind="writer_stall", duration_s=1.0),
    ])))

register_scenario(ScenarioSpec(
    name="shard_scale",
    description="Mixed zipfian read/update stream against the 4-way "
                "sharded vector DB (repro.sharded): shard-parallel scan "
                "plus the O(shards·k) merge reduction must hold retrieval "
                "tails flat while the hash router keeps every mutation "
                "shard-local behind the serialized writer.",
    arrival=ArrivalSpec(process="poisson", target_qps=80.0),
    mix=MixSpec(query_frac=0.8, update_frac=0.2, distribution="zipfian"),
    n_docs=64, n_requests=320, slo_ms=150.0, seed=0,
    autoscale=_AUTOSCALE,
    pipeline={"vectordb": {"component": "torch_sharded",
                           "options": {"n_shards": 4}}}))

register_scenario(ScenarioSpec(
    name="diurnal_ramp",
    description="Sinusoidally ramping load (one trough→peak→trough 'day'): "
                "the slow swell regime where scale-up must track the ramp "
                "and scale-down must follow it back.",
    arrival=ArrivalSpec(process="diurnal", target_qps=160.0,
                        ramp_period_s=4.0, ramp_amplitude=0.8),
    mix=MixSpec(query_frac=0.9, update_frac=0.1),
    n_docs=64, n_requests=480, slo_ms=150.0, seed=0,
    autoscale=_AUTOSCALE))
