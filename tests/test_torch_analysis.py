"""The port's invariant linter and lock-order detector
(``repro_torch.analysis``) against the reference's (``repro.analysis``), on
the CPU.

The two AST passes are copies, so on the same files (the reference's tree,
the port's tree, the reference test's planted sources) both give the same
findings. ``gauge-schema`` and ``conformance`` read each package's own
schema, registry, specs, scenario catalog and experiment table: a planted
defect gets the same message from both, the port's tree is clean, and the
two gauge schemas differ only where the port measures torch's device
memory. The lock-order detector's unit cases hold for both modules, and
the reference's chaos workload runs on the port over the ``torch`` and
``torch_sharded`` DBs with an acyclic lock order
(``scripts/lock_order.py``, which ``chip_smoke.py`` runs on the card).
"""
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
import threading
from dataclasses import dataclass

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.analysis import conformance as jconformance  # noqa: E402
from repro.analysis import core as jcore  # noqa: E402
from repro.analysis import gauge_schema as jgauge_schema  # noqa: E402
from repro.analysis import lockorder as jlockorder  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro_torch.analysis import __main__ as tcli  # noqa: E402
from repro_torch.analysis import conformance as tconformance  # noqa: E402
from repro_torch.analysis import core as tcore  # noqa: E402
from repro_torch.analysis import gauge_schema as tgauge_schema  # noqa: E402
from repro_torch.analysis import lockorder as tlockorder  # noqa: E402
from repro_torch.core import registry as tregistry  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
STATIC = ["lock-discipline", "clock-purity"]


def py_files(*dirs):
    return sorted(str(p) for d in dirs
                  for p in pathlib.Path(REPO, d).rglob("*.py")
                  if "__pycache__" not in p.parts)


def dicts(findings):
    return [f.to_dict() for f in findings]


@pytest.mark.parametrize("tree", ["reference", "port", "planted"])
def test_static_passes_match_reference(tree, tmp_path):
    """``lock-discipline`` and ``clock-purity`` give the reference's
    findings, suppressions included, on the same files."""
    root = REPO
    if tree == "reference":
        paths = py_files("src/repro", "benchmarks")
    elif tree == "port":
        paths = py_files("src/repro_torch")
    else:
        root = str(tmp_path)
        for fn in os.listdir(FIXTURES):
            if fn.endswith(".py"):
                shutil.copy(os.path.join(FIXTURES, fn), tmp_path / fn)
        paths = sorted(str(p) for p in tmp_path.glob("*.py"))
    want, want_sup = jcore.run_passes(root, paths=paths, passes=STATIC)
    got, got_sup = tcore.run_passes(root, paths=paths, passes=STATIC)
    assert dicts(got) == dicts(want) and got_sup == want_sup
    if tree == "planted":   # the fixtures' violations are found
        assert {f.pass_id for f in got} == set(STATIC) and got_sup == 1


PLANTED_GAUGES = '''\
class Thing:
    def gauges(self):
        return {
            "my_adhoc_key": lambda: 1.0,
            "db_live": lambda: 2.0,
            "serving_queue_depth": lambda: 3.0,
            "torch_device_bytes": lambda: 4.0,
            "jax_device_bytes": lambda: 5.0,
        }


def wire(mon, name):
    mon.add_gauge("cpu_util", lambda: 0.0)
    mon.add_gauge("bogus_metric", lambda: 0.0)
    mon.add_gauge(f"stage_{name}_ms", lambda: 0.0)
    mon.add_gauge(f"weird_{name}", lambda: 0.0)
    mon.add_gauges({"elastic_x": lambda: 0.0, "nope": lambda: 0.0})
'''


def test_gauge_schema_matches_reference(tmp_path):
    """On names both schemas share, the same findings; the port's schema
    holds ``torch_device_bytes`` where the reference's holds
    ``jax_device_bytes``."""
    (tmp_path / "planted.py").write_text(PLANTED_GAUGES)
    want = dicts(jgauge_schema.run([jcore.SourceFile(
        str(tmp_path), str(tmp_path / "planted.py"))], str(tmp_path)))
    got = dicts(tgauge_schema.run([tcore.SourceFile(
        str(tmp_path), str(tmp_path / "planted.py"))], str(tmp_path)))

    def shared(found):
        return [f for f in found if "_device_bytes" not in f["message"]]

    assert shared(got) == shared(want)
    assert {m for f in shared(got) for m in
            ("my_adhoc_key", "bogus_metric", "weird_", "nope")
            if f"'{m}" in f["message"]} == {"my_adhoc_key", "bogus_metric",
                                            "weird_", "nope"}
    assert len(shared(got)) == 4
    flagged = [f["message"] for f in got if "_device_bytes" in f["message"]]
    assert len(flagged) == 1 and "'jax_device_bytes'" in flagged[0]
    ref_flagged = [f["message"] for f in want
                   if "_device_bytes" in f["message"]]
    assert len(ref_flagged) == 1 and "'torch_device_bytes'" in ref_flagged[0]


def test_port_conformance_is_clean():
    findings = tconformance.run([], REPO)
    assert not findings, "\n".join(f.render() for f in findings)


class ProbeDB:
    """A vector DB that lacks most of its protocol."""

    def insert(self, vecs, chunks):
        return []

    def search(self, q, k):
        return []


@pytest.mark.parametrize("kind,name", [("vectordb", "conformance_probe"),
                                       ("reranker", "conformance_probe")])
def test_conformance_flags_missing_protocol_method(kind, name):
    """One planted component, registered in each package's registry, gets
    the same findings from both."""
    found = []
    for registry, conformance in ((jregistry, jconformance),
                                  (tregistry, tconformance)):
        registry.available()      # the built-ins first
        registry.register(kind, name)(ProbeDB)
        try:
            found.append([f for f in conformance._protocol_findings(REPO)
                          if f"'{name}'" in f.message])
        finally:
            registry._REGISTRY[kind].pop(name)
    want, got = (dicts(f) for f in found)
    assert got == want and got
    missing = {"vectordb": {"remove", "build_index", "get_chunk",
                            "get_chunks", "stats"},
               "reranker": {"rerank"}}[kind]
    assert {f["message"].split("method ")[1][:-2] for f in got} == missing
    assert name not in tregistry.available(kind)


@dataclass
class LaxSpec:
    """A spec whose ``from_dict`` ignores keys it does not know."""

    a: int = 1

    def to_dict(self):
        return {"a": self.a}

    @classmethod
    def from_dict(cls, d):
        return cls(a=d.get("a", 1))


def test_conformance_flags_lax_spec():
    want = dicts(jconformance.check_spec_roundtrip(LaxSpec, {"a": 3}, REPO))
    got = dicts(tconformance.check_spec_roundtrip(LaxSpec, {"a": 3}, REPO))
    assert got == want and len(got) == 1
    assert "accepts unknown keys" in got[0]["message"]
    assert got[0]["path"] == "tests/test_torch_analysis.py"


def test_conformance_flags_unregistered_experiment(tmp_path):
    """An experiment module missing from ``MODULES`` (and the missing
    ``fused_retrieve`` gate) gets the reference's findings with the
    port's paths."""
    port_dir = tconformance.EXPERIMENTS_DIR
    for d in ("benchmarks", port_dir):
        (tmp_path / d).mkdir(parents=True)
        for mod in ("__init__", "common", "listed", "orphan"):
            (tmp_path / d / f"{mod}.py").write_text("")
        (tmp_path / d / "run.py").write_text(
            "from . import listed\n\nMODULES = {\"listed\": listed}\n")
    want = dicts(jconformance._benchmark_registration_findings(
        str(tmp_path)))
    got = dicts(tconformance._benchmark_registration_findings(
        str(tmp_path)))
    moved = json.loads(json.dumps(want).replace("benchmarks/",
                                                f"{port_dir}/"))
    assert got == moved and len(got) == 2
    assert any("'orphan' is not registered" in f["message"] for f in got)
    assert any("'fused_retrieve' is missing" in f["message"] for f in got)


def _abba(mod):
    g = mod.LockOrderGraph()
    a, b = mod.InstrumentedLock(g, "a"), mod.InstrumentedLock(g, "b")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    for fn in (ab, ba):   # sequential: the cycle is in the order only
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()
    return g


def _reentrant(mod):
    g = mod.LockOrderGraph()
    r = mod.InstrumentedLock(g, "r", threading.RLock())
    with r:
        with r:
            pass
    return g


def _nested(mod):
    g = mod.LockOrderGraph()
    outer = mod.InstrumentedLock(g, "outer")
    inner = mod.InstrumentedLock(g, "inner")
    with outer:
        with inner:
            pass
    return g


def _outcome(mod, case):
    g = case(mod)
    try:
        g.assert_acyclic()
        error = None
    except mod.LockOrderError as e:
        error = str(e)
    return g.edges(), g.cycles(), g.acquisitions(), error


@pytest.mark.parametrize("case,edges,cyclic", [
    (_abba, [("a", "b"), ("b", "a")], True),
    (_reentrant, [], False),
    (_nested, [("outer", "inner")], False)],
    ids=["abba", "reentrant", "nested"])
@pytest.mark.parametrize("mod", [jlockorder, tlockorder],
                         ids=["reference", "port"])
def test_lockorder_cases(mod, case, edges, cyclic):
    """Each module gives the expected edges and error, and the same ones
    as the reference's."""
    got = _outcome(mod, case)
    assert got == _outcome(jlockorder, case)
    assert got[0] == edges and (got[3] is not None) == cyclic
    if cyclic:
        assert any(set(c) == {"a", "b"} for c in got[1])


def _lock_order_script():
    spec = importlib.util.spec_from_file_location(
        "lock_order_script", os.path.join(REPO, "scripts", "lock_order.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("db", ["torch", "torch_sharded"])
def test_chaos_lock_order_acyclic(db):
    """The reference's elastic + writer + chaos workload on the port, with
    the executor's, DB's, timer's, accountant's, launch counter's and
    kernel loader's locks instrumented: acyclic, and the executor's and
    DB's locks taken."""
    script = _lock_order_script()
    g, seconds = script.run(db, device="cpu")
    # the process-wide locks are handed back for the next run's graph
    for owner in (script.ops._COUNTS, script._build):
        assert not isinstance(owner._lock, tlockorder.InstrumentedLock)
    acq = g.acquisitions()
    assert script.acquired(acq, "elastic._lock") > 0
    assert script.acquired(acq, "vectordb._mu") > 0
    assert acq.get("accountant._lock", 0) == 24
    if db == "torch_sharded":
        assert acq.get("sharded._mu", 0) > 0
        assert all(b.startswith("vectordb._mu[") for a, b in g.edges()
                   if a == "sharded._mu")
    g.assert_acyclic()
    assert seconds > 0


def test_cli_check_clean_on_tree():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s): 0 new" in out.stdout
    with open(os.path.join(REPO, tcore.BASELINE_NAME)) as f:
        assert json.load(f) == {"findings": []}


def test_cli_check_fails_on_planted_file(tmp_path, capsys):
    """A finding outside the (empty) baseline makes ``--check`` exit 2."""
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "analysis").mkdir(parents=True)
    shutil.copy(os.path.join(REPO, tcore.BASELINE_NAME),
                tmp_path / tcore.BASELINE_NAME)
    shutil.copy(os.path.join(FIXTURES, "clock_violation.py"),
                pkg / "planted.py")
    argv = ["--root", str(tmp_path), "--passes", ",".join(STATIC)]
    assert tcli.main(argv) == 0            # a report alone passes
    assert tcli.main(["--check", *argv]) == 2
    out = capsys.readouterr()
    assert "src/repro_torch/planted.py" in out.out
    assert "3 new" in out.out and "FAIL" in out.err
