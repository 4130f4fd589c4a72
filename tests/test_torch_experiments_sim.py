"""The port's simulated studies (``repro_torch.experiments``: scenarios,
chaos) and golden-dict helpers (``repro_torch.scenarios.golden_dict``,
``diff_golden``) against a live run of the JAX package's, on the CPU.

Never against ``tests/golden/``: the reference's recorded traces drift on
this tree, and the port neither reads nor writes them. The port's scenario
pipelines take the reference's hash table, DB state and k-means draws (the
``reference_state`` stand-in of ``test_torch_scenarios.py``), and then
every value is held: the studies' rows by ``compare_rows`` (counts and
event numbers equal, quality equal, virtual-time latencies and rates
within ``SIM_TOL``), each golden variant's ``golden_dict`` equal to the
reference's.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_scenarios import reference_state  # noqa: E402,F401

import test_torch_experiments_figures  # noqa: E402,F401  (the reference's path)

from benchmarks import chaos as bchaos  # noqa: E402
from benchmarks import scenarios as bscenarios  # noqa: E402
from repro.scenarios.runner import (  # noqa: E402
    GOLDEN_DIR as J_GOLDEN_DIR)
from repro.scenarios.runner import (  # noqa: E402
    GOLDEN_SUMMARY_KEYS as J_GOLDEN_KEYS)
from repro.scenarios import ScenarioRunner as JRunner  # noqa: E402
from repro.scenarios import diff_golden as jdiff_golden  # noqa: E402
from repro.scenarios import golden_dict as jgolden_dict  # noqa: E402
from repro.scenarios import golden_variant as jgolden_variant  # noqa: E402
from repro_torch import scenarios as tscenarios_pkg  # noqa: E402
from repro_torch.experiments import chaos as tchaos  # noqa: E402
from repro_torch.experiments import common as tcommon  # noqa: E402
from repro_torch.experiments import scenarios as tscenarios  # noqa: E402
from repro_torch.scenarios import (GOLDEN_SUMMARY_KEYS, ScenarioRunner,  # noqa: E402
                                   diff_golden, golden_dict, golden_variant,
                                   scenario_names)

SCALE = 0.01


def as_reference(doc):
    """A port golden dict under the reference's component names (its
    sharded DB is ``sharded``; the port's ``torch_sharded``)."""
    return json.loads(json.dumps(doc).replace('"torch_sharded"',
                                              '"sharded"'))


@pytest.mark.parametrize("name", ["scenarios", "chaos"])
def test_sim_study_matches_reference(name, reference_state):
    ref, port = {"scenarios": (bscenarios, tscenarios),
                 "chaos": (bchaos, tchaos)}[name]
    want = ref.run(SCALE)
    got = port.run(SCALE, device="cpu")
    held = tcommon.compare_rows(want, got)
    assert held == len(got) * (len(got[0]) - 1)     # every value held
    assert all(r["deterministic"] == 1.0 for r in got)


@pytest.mark.parametrize("name", scenario_names())
def test_golden_dict_matches_reference_live(name, reference_state):
    """Each golden variant's dict equals the reference's from a live JAX
    ``simulate()``: the spec, every event, timeline and fault, the rounded
    summary, quality and decomposition."""
    jspec = jgolden_variant(name)
    want = jgolden_dict(JRunner(jspec).simulate(), jspec)
    spec = golden_variant(name)
    got = as_reference(golden_dict(
        ScenarioRunner(spec, device="cpu").simulate(), spec))
    assert diff_golden(want, got) == [] and got == want
    assert set(got["summary"]) <= set(GOLDEN_SUMMARY_KEYS)


def test_golden_helpers_are_the_references():
    assert GOLDEN_SUMMARY_KEYS == J_GOLDEN_KEYS
    assert {"GOLDEN_SUMMARY_KEYS", "golden_dict", "diff_golden"} <= set(
        tscenarios_pkg.__all__)
    # the port's recorder writes its own directory, never the reference's
    assert {"GOLDEN_DIR", "golden_path"} <= set(tscenarios_pkg.__all__)
    assert callable(tscenarios.regen)
    assert os.path.realpath(tscenarios_pkg.GOLDEN_DIR) != os.path.realpath(
        J_GOLDEN_DIR)
    assert os.path.dirname(tscenarios_pkg.golden_path("steady")) == \
        tscenarios_pkg.GOLDEN_DIR
    a = {"x": 1, "y": [1, 2], "z": {"k": 0.5}}
    for b in (dict(a), {"x": 1, "y": [1, 3], "w": 0},
              {"y": [1, 2], "z": {"k": 0.25}}):
        assert diff_golden(a, b) == jdiff_golden(a, b)


def test_scenarios_check_finds_a_difference(monkeypatch):
    """``scenarios.check`` replays a golden variant twice; a second run
    that differs is reported."""
    assert tscenarios.check("steady", device="cpu") == []
    simulate = ScenarioRunner.simulate
    runs = []

    def drifting(self, *args, **kw):
        report = simulate(self, *args, **kw)
        runs.append(report)
        if len(runs) == 2:
            report.summary["goodput_qps"] += 1e-3
            report.fault_events = [{"action": "inject"}]
        return report

    monkeypatch.setattr(ScenarioRunner, "simulate", drifting)
    failures = tscenarios.check("steady", device="cpu")
    assert any("fault log differs" in f for f in failures)
    assert any(f.startswith("steady: summary:") for f in failures)


@pytest.mark.parametrize("module", [tscenarios, tchaos])
def test_check_cli_exits_zero(module, capsys):
    argv = ["--check", "--device", "cpu"]
    if module is tscenarios:
        argv += ["--only", "writer_stall"]
    assert module.main(argv) == 0
    assert "CHECK OK" in capsys.readouterr().out
