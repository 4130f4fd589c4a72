"""The port's ``update_freshness`` example against the JAX package's, on
the CPU, with the stand-ins of ``test_torch_examples.py`` (the reference's
hash table and k-means draws carried across): each configuration's
rebuilds equal, its recall and exact-match rate within ``QUALITY_TOL``
(printed to 2 decimals; the workload rebuilds the IVF index mid-run, and
the two packages' k-means sums differ in their last bits)."""
import re
import sys

import pytest

pytest.importorskip("torch")

from test_torch_examples import (QUALITY_TOL, ROOT,  # noqa: E402,F401
                                 reference_draws, tfresh)

sys.path.insert(0, ROOT)   # the reference's examples/ (no __init__.py)

from examples import update_freshness as jfresh  # noqa: E402


def test_update_freshness_matches_reference(reference_draws, capsys):
    jfresh.main()
    out = capsys.readouterr().out.splitlines()[1:]
    got = tfresh.main(["--device", "cpu"])
    assert len(out) == len(got) == 3
    for line, (name, rec) in zip(out, got.items()):
        assert line.startswith(name)
        vals = dict(re.findall(r"(\w+)=\s*([\d.]+)", line))
        assert rec["rebuilds"] == float(vals["rebuilds"]), name
        for key, short in (("context_recall", "recall"), ("exact", "exact")):
            assert abs(rec[key] - float(vals[short])) <= QUALITY_TOL, name
        assert rec["qps"] > 0
