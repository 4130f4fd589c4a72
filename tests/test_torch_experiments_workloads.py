"""The port's workload experiments (``repro_torch.experiments``: Figs.
9-12) against the JAX package's ``benchmarks/``, on the CPU, with the
stand-ins and the row rules of ``test_torch_experiments_figures.py`` (the
reference's hash tables and k-means draws carried across; counts, bytes
and quality equal, timing fields present and not negative). Split from that file so the
slowest experiments run on two workers."""
import pytest

pytest.importorskip("torch")

from test_torch_experiments_figures import (  # noqa: E402,F401
    reference_draws, run_both)

HERE = ["update_workload", "resource_limits", "sensitivity",
        "index_schemes"]


@pytest.mark.parametrize("name", HERE)
def test_experiment_matches_reference(name, reference_draws):
    run_both(name, reference_draws)
