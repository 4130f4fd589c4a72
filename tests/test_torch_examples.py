"""The port's examples (``repro_torch.examples``) against the JAX package's
``examples/``, on the CPU, each through its ``main`` with ``--device cpu``
(``update_freshness`` in ``test_torch_examples_updates.py``, which takes
this file's stand-ins, so the two halves run on two workers).

The port's pipelines take the reference's draws: its hash tables
(``convert.embedder_from_jax``), its generation weights
(``convert.model_llm_from_jax``) and every k-means run's initial draw
(``jax.random.choice``, injected into ``repro_torch.core.vectordb.kmeans``).
Then the numbers each reference example prints must match the port's:

* ``quickstart``: the chunks indexed and the DB's counts equal; the quality
  metrics within ``QUALITY_TOL`` (the mixed workload rebuilds its IVF index
  mid-run, and the two packages' k-means sums differ in their last bits);
* ``update_freshness``: each configuration's rebuilds equal, its recall
  and exact-match rate within ``QUALITY_TOL`` (printed to 2 decimals);
* ``serve_multiarch --arch llama3_8b``: the same generated answers;
* ``train_e2e``: the first step's loss within 1e-4 of the reference's
  (printed to 4 decimals), from the reference's initial state; 3 steps,
  then a relaunch to 5 that restores the checkpoint at 3 and ends bit for
  bit where an uninterrupted 5-step run ends (the learning rate is in its
  warm-up, where the schedule does not read the step count); the trained
  model then serves.
"""
import ast
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)   # the reference's examples/ (no __init__.py)

from examples import quickstart as jquick  # noqa: E402
from examples import serve_multiarch as jserve  # noqa: E402
from examples import train_e2e as jtrain  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core.generator import ModelLLM as JModelLLM  # noqa: E402
from repro.core.registry import create as jcreate  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train.train_step import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.train_step import init_train_state as jinit  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import vectordb as tvdb  # noqa: E402
from repro_torch.examples import quickstart as tquick  # noqa: E402
from repro_torch.examples import serve_multiarch as tserve  # noqa: E402
from repro_torch.examples import train_e2e as ttrain  # noqa: E402
from repro_torch.examples import update_freshness as tfresh  # noqa: E402

QUALITY_TOL = 0.02
COUNTS = ("live", "slots", "vector_bytes", "index_bytes", "fresh", "inserts",
          "removals", "searches", "rebuilds")


@pytest.fixture
def reference_draws(monkeypatch):
    """The examples' pipelines hold the reference's hash table, and every
    port k-means run starts from the reference's draw."""
    kmeans = tvdb.kmeans
    table = convert.embedder_from_jax(jcreate("embedder", "hash", dim=384))

    def from_reference_init(x, k, iters=10, seed=0, init=None):
        if init is None:
            n = x.shape[0]
            idx = np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                             (k,), replace=n < k))
            init = x[torch.from_numpy(idx).long()]
        return kmeans(x, k, iters, seed, init=init)

    monkeypatch.setattr(tvdb, "kmeans", from_reference_init)
    for mod in (tquick, tfresh, tserve, ttrain):
        build = mod.build

        def with_table(spec, _build=build, **kw):
            assert spec.embedder.options.get("dim", 384) == 384
            return _build(spec, embedder=table, **kw)

        monkeypatch.setattr(mod, "build", with_table)


def printed(out: str, label: str):
    """The dict a reference example printed after ``label``."""
    line = next(x for x in out.splitlines() if x.startswith(label))
    return ast.literal_eval(line[len(label):].strip())


def test_quickstart_matches_reference(reference_draws, capsys):
    jquick.main()
    out = capsys.readouterr().out
    got = tquick.main(["--device", "cpu"])
    tout = capsys.readouterr().out
    n = int(re.search(r"indexed (\d+) chunks", out).group(1))
    assert got["n_chunks"] == n
    want_q = printed(out, "quality:")
    assert set(got["quality"]) == set(want_q)
    for key, val in want_q.items():
        assert abs(got["quality"][key] - val) <= QUALITY_TOL, key
    want_db, got_db = printed(out, "db stats:"), printed(tout, "db stats:")
    assert {k: got_db[k] for k in COUNTS} == {k: want_db[k] for k in COUNTS}
    assert got["qps"] > 0 and got["queries"] == want_db["searches"]


def test_serve_multiarch_matches_reference(reference_draws, monkeypatch,
                                           capsys):
    pipes = []

    class Recorded(jserve.RAGPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            pipes.append(self)

    monkeypatch.setattr(jserve, "RAGPipeline", Recorded)
    monkeypatch.setattr(sys, "argv", ["serve_multiarch", "--arch",
                                      "llama3_8b"])
    jserve.main()

    def reference_llm(cfg, max_prompt, max_new, batch_size, device):
        jcfg = jconfigs.get_smoke("llama3_8b")
        assert cfg.name == jcfg.name
        return convert.model_llm_from_jax(
            JModelLLM(jcfg, max_prompt=max_prompt, max_new=max_new,
                      batch_size=batch_size), device=device)

    monkeypatch.setattr(tserve, "ModelLLM", reference_llm)
    got = tserve.main(["--arch", "llama3_8b", "--device", "cpu"])
    want = [t.answer for t in pipes[0].traces]
    assert len(want) == 8 and got["llama3_8b"]["answers"] == want
    assert got["llama3_8b"]["n_requests"] == 8
    assert 0 < got["llama3_8b"]["generation_frac"] < 1
    assert capsys.readouterr().out.startswith("llama3_8b ")


def _params(state):
    return {k: v.detach().clone() for k, v in state["params"].items()}


def test_train_e2e_restarts_bit_for_bit_and_serves(reference_draws,
                                                   monkeypatch, tmp_path,
                                                   capsys):
    # the reference's first step, from its own initial state
    monkeypatch.setattr(sys, "argv", ["train_e2e", "--steps", "1",
                                      "--ckpt-dir", str(tmp_path / "jax")])
    jtrain.main()
    want0 = float(re.search(r"step    0 loss=([\d.]+)",
                            capsys.readouterr().out).group(1))
    jcfg = JModelConfig(**{f: getattr(ttrain.CFG, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "activation", "rope_type", "remat", "dtype")})

    def init_from_reference(seed, cfg, tcfg, device):
        jstate = jinit(jax.random.PRNGKey(seed), jcfg, JTrainConfig(
            opt=JAdamWConfig(lr=tcfg.opt.lr, warmup_steps=20,
                             total_steps=tcfg.opt.total_steps)))
        return convert.train_state_from_jax(jstate, cfg, device)

    monkeypatch.setattr(ttrain, "init_train_state", init_from_reference)
    argv = ["--device", "cpu", "--ckpt-dir"]
    first = ttrain.main(["--steps", "3", *argv, str(tmp_path / "a")])
    assert abs(first["losses"][0] - want0) <= 1e-4
    again = ttrain.main(["--steps", "5", *argv, str(tmp_path / "a")])
    whole = ttrain.main(["--steps", "5", *argv, str(tmp_path / "b")])
    assert (first["start"], again["start"], whole["start"]) == (0, 3, 0)
    assert again["checkpoints"] == [3, 5] and whole["checkpoints"] == [5]
    a, b = _params(again["state"]), _params(whole["state"])
    assert all(torch.equal(a[k], b[k]) for k in b)
    assert again["losses"][4] == whole["losses"][4]
    assert whole["losses"][4] < whole["losses"][0]
    for run in (first, again, whole):
        assert run["tok_s"] > 0
        assert run["served"]["n_requests"] == 4
        assert len(run["served"]["answers"]) == 4
    assert "restarting from checkpoint at step 3" in capsys.readouterr().out
