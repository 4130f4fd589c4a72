"""Each fault a search cell can have, planted underneath the timed path of
a tiny run on the CPU: ``correct`` comes out false, through a number that
the same run passes unbroken."""
import pytest

from ragbench.control import plant_kmeans_fault
from ragbench.tests.test_ragbench_run import CELLS, over, tiny_run

CLEAN = {}
IVF = next(c for c in CELLS if ".ivf" in c)


def clean(name):
    if name not in CLEAN:
        CLEAN[name] = tiny_run(name)[1]
    return CLEAN[name]


def _db_fault():
    from repro_torch.core.vectordb import TorchVectorDB

    search = TorchVectorDB.search

    def answer(self, vectors, k):            # a search answer altered
        res = search(self, vectors, k)
        res[0].chunk_ids = res[0].chunk_ids[::-1].copy()
        res[0].scores = res[0].scores[::-1].copy()
        return res

    return TorchVectorDB, "search", answer


def _fresh_fault():
    from repro_torch.core import vectordb

    def main_only(sa, ia, sb, ib, k):        # the freshness scan dropped
        return sa, ia

    return vectordb, "merge_topk", main_only


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS for f in ("search", "fresh")] + [(IVF, "kmeans")])
def test_a_broken_timed_path_reads_not_correct(name, fault, monkeypatch):
    if fault == "search":
        monkeypatch.setattr(*_db_fault())
    elif fault == "fresh":
        monkeypatch.setattr(*_fresh_fault())
    else:
        # the index trained for no round: its centroids are sample rows
        from repro_torch.core import vectordb

        monkeypatch.setattr(vectordb, "kmeans", vectordb.kmeans)
        plant_kmeans_fault(rounds=0)
    _, line = tiny_run(name)
    assert line["correct"] is False
    monkeypatch.undo()
    ok = clean(name)
    # a number that the same run passes unbroken fails broken
    assert over(line) - over(ok), (line["checks"], ok["checks"])
