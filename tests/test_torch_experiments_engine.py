"""The port's generation-engine study (``repro_torch.experiments.
gen_engine``) against the JAX package's ``benchmarks/gen_engine.py``, on
the CPU.

Both packages run the study at scale ``SCALE`` (the reference's floor of
32 requests) on ``BENCH_CFG`` with the same weights: the port's
``ModelLLM`` is the reference's, carried across by
``convert.model_llm_from_jax``. ``compare_rows`` holds the row (the
equivalence flag equal, and true; offered load and TTFTs measurements of
the run). The TTFT-p95 win is a timing gate: it runs on the card
(``chip_smoke.py``), not here.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_experiments_figures  # noqa: E402,F401  (the reference's path)

from benchmarks import gen_engine as bgen  # noqa: E402
from repro.core.generator import ModelLLM as JModelLLM  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.generator import ModelLLM  # noqa: E402
from repro_torch.experiments import common as tcommon  # noqa: E402
from repro_torch.experiments import gen_engine as tgen  # noqa: E402

SCALE = 0.01


@pytest.fixture
def reference_weights(monkeypatch):
    """``gen_engine``'s model is the reference's: the same config, sizes,
    seed and weights. Lists the models built."""
    built = []

    def model_llm(cfg, max_prompt, max_new, batch_size, seed, device):
        assert cfg == tgen.BENCH_CFG
        built.append(cfg.name)
        return convert.model_llm_from_jax(
            JModelLLM(bgen.BENCH_CFG, max_prompt=max_prompt,
                      max_new=max_new, batch_size=batch_size, seed=seed),
            device=device)

    monkeypatch.setattr(tgen, "ModelLLM", model_llm)
    return built


def test_gen_engine_matches_reference(reference_weights):
    want = bgen.run(SCALE)
    got = tgen.run(SCALE, device="cpu")
    assert tcommon.compare_rows(want, got) == 1
    assert got[0]["equivalent"] == 1
    assert reference_weights == ["genengine-bench"]


def test_bench_config_is_the_references():
    assert convert.model_config(bgen.BENCH_CFG) == tgen.BENCH_CFG
    assert tgen._prompts(12, seed=3) == bgen._prompts(12, seed=3)


@pytest.mark.parametrize("verdict", [True, False])
def test_point_takes_a_prebuilt_model_and_a_rule(verdict):
    """``_point`` runs on the ``ModelLLM`` it is handed, and its
    equivalence is the rule's verdict on both comparisons: offline and
    under load, each with the lock-step answers first."""
    llm = ModelLLM(configs.get_smoke("llama3_8b"), max_prompt=32,
                   max_new=3, batch_size=2, seed=0, device="cpu")
    calls = []

    def rule(questions, want, got):
        calls.append((list(questions), list(want), list(got)))
        return verdict

    p = tgen._point(n_req=4, batch=2, slots=3, chunk_tokens=8,
                    max_prompt=32, max_new=3, device="cpu", llm=llm,
                    same=rule)
    assert p["equivalent"] is verdict
    assert len(calls) == 2 and llm.stats.n_requests > 0
    for questions, want, got in calls:
        assert questions == tgen._prompts(4, 0)
        assert len(want) == len(got) == 4
        assert want == got        # the smoke model's tokens, both paths


def test_check_is_the_references():
    good = {"equivalent": True, "engine_ttft_p95_ms": 50.0,
            "lockstep_ttft_p95_ms": 260.0}
    assert tgen.check([good]) == []
    bad = tgen.check([dict(good, equivalent=False,
                           engine_ttft_p95_ms=300.0)])
    assert len(bad) == 2 and "changed outputs" in bad[0]
    assert "no TTFT p95 win" in bad[1]
