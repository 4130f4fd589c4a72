"""Each cell run whole at its configuration's tiny size on the CPU, past the
harness's look for a card: the result line's keys, the numbers compared
beside their limits, ``correct`` false with the timed path broken
underneath (``test_ragbench_faults``), no JAX loaded, and a refusal without
a card."""
import json
import subprocess
import sys

import pytest

from ragbench import run as R
from ragbench.cell import ROOT, load_cell, manifest

CELLS = [w["name"] for w in manifest()["workloads"]]
SEED = 2 ** 31 + 5
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def over(line):
    return {k for k, c in line["checks"].items() if c["value"] > c["limit"]}


def tiny_run(name, trace=False, seconds=1.5):
    """A tiny run's result line (its JAX check is ``test_no_jax_is_loaded``'s,
    in a fresh interpreter: other test files load JAX in this one)."""
    cell = load_cell(name, tiny=True)
    out, _ = R.run(cell, SEED, seconds, trace, device="cpu")
    return cell, json.loads(R.result_line(out))


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_prints_the_contract_line(name):
    cell, line = tiny_run(name)
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == set(cell.metric_names(False))
    assert line["device"]["platform"] == "cpu"
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] is not None
    assert isinstance(line["correct"], bool)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_run(name):
    cell, line = tiny_run(name, trace=True, seconds=3.0)
    assert set(line) == KEYS | {"breakdown"}
    assert set(line["metrics"]) <= set(cell.metric_names(True))
    assert "busy_s" in line["device"] and "window_s" in line["device"]


def test_no_jax_is_loaded():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from ragbench import run as R\n"
            "from ragbench.cell import load_cell\n"
            "R.setup_paths()\n"
            "out, _ = R.run(load_cell(%r, tiny=True), 3, 1.0, False, "
            "device='cpu')\n"
            "print(R.forbidden_modules())\n" % (
                str(ROOT), str(ROOT / "src"), CELLS[0]))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card(tmp_path):
    """No card here: a non-zero exit and no result line, from the checkout
    and from a folder that holds only the benchmark."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ragbench", tmp_path / "ragbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "ragbench/run.py", "--workload", CELLS[0],
             "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=where)
        assert p.returncode != 0 and not p.stdout.strip()
