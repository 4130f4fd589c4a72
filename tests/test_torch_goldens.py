"""The port's golden traces (``src/repro_torch/scenarios/golden/``), on the
CPU.

The port records its own traces with its own draws (the hash table and the
k-means seeds from CPU ``torch.Generator``s), so they are not the
reference's ``tests/golden/`` files. Every registered scenario has one; a
fresh ``simulate()`` of its golden variant equals it (``diff_golden``
empty); and ``regen`` writes the committed bytes.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.experiments import scenarios as tscenarios  # noqa: E402
from repro_torch.scenarios import (GOLDEN_DIR, ScenarioRunner,  # noqa: E402
                                   diff_golden, golden_dict, golden_path,
                                   golden_variant, runner, scenario_names)


def test_every_scenario_has_a_golden_trace():
    recorded = sorted(fn[:-len(".json")] for fn in os.listdir(GOLDEN_DIR)
                      if fn.endswith(".json"))
    assert recorded == sorted(scenario_names())
    assert len(recorded) == 9


@pytest.mark.parametrize("name", scenario_names())
def test_golden_trace_replays_on_the_cpu(name):
    with open(golden_path(name)) as f:
        expected = json.load(f)
    spec = golden_variant(name)
    got = golden_dict(ScenarioRunner(spec, device="cpu").simulate(), spec)
    assert diff_golden(expected, got) == []


@pytest.mark.parametrize("name", scenario_names())
def test_regen_writes_the_committed_bytes(name, tmp_path, monkeypatch):
    committed = golden_path(name)
    monkeypatch.setattr(runner, "GOLDEN_DIR", str(tmp_path / "golden"))
    written = tscenarios.regen(name, device="cpu")
    assert written == [str(tmp_path / "golden" / f"{name}.json")]
    assert committed != written[0]
    with open(written[0], "rb") as f, open(committed, "rb") as g:
        assert f.read() == g.read()


def test_check_names_the_regen_command(tmp_path, monkeypatch):
    """A missing trace is a failure that says how to record it."""
    monkeypatch.setattr(runner, "GOLDEN_DIR", str(tmp_path))
    failures = tscenarios.check("steady", device="cpu")
    assert len(failures) == 1 and "no golden trace" in failures[0]
    assert "--regen" in failures[0] and "--only steady" in failures[0]


def test_check_holds_the_replay_to_the_recorded_trace(tmp_path,
                                                      monkeypatch):
    """A recorded trace that differs from the replay fails ``--check``,
    though the two replays agree."""
    with open(golden_path("steady")) as f:
        doc = json.load(f)
    doc["summary"]["goodput_qps"] += 1e-3
    (tmp_path / "steady.json").write_text(json.dumps(doc))
    monkeypatch.setattr(runner, "GOLDEN_DIR", str(tmp_path))
    failures = tscenarios.check("steady", device="cpu")
    assert len(failures) == 1
    assert failures[0].startswith(
        f"steady: against {tmp_path / 'steady.json'}: summary:")
