"""First-class benchmark scenarios of the port: declarative specs, a named
catalog, a wall-clock-free deterministic simulator, and one unified report
schema with quality-aware SLO goodput (``repro_torch.scenarios.runner``)."""
from repro_torch.scenarios.registry import (get_scenario, golden_variant,
                                            register_scenario, scenario_names)
from repro_torch.scenarios.runner import (GOLDEN_DIR, GOLDEN_SUMMARY_KEYS,
                                          ScenarioReport, ScenarioRunner,
                                          diff_golden, golden_dict,
                                          golden_path)
from repro_torch.scenarios.sim import CostModel, ScenarioSim
from repro_torch.scenarios.spec import ArrivalSpec, MixSpec, ScenarioSpec

__all__ = [
    "ArrivalSpec", "CostModel", "GOLDEN_DIR", "GOLDEN_SUMMARY_KEYS",
    "MixSpec", "ScenarioReport", "ScenarioRunner", "ScenarioSim",
    "ScenarioSpec", "diff_golden", "get_scenario", "golden_dict",
    "golden_path", "golden_variant", "register_scenario", "scenario_names",
]
