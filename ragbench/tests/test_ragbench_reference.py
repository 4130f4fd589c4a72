"""The plain reference agrees with the port at small sizes on the CPU: the
search judge over the port's DB, and the k-means worked out again from the
rows against the port's index."""
import numpy as np
import torch

from ragbench.reference import search as RS


def test_tf32_control_rounds_to_ten_mantissa_bits():
    x = torch.randn(1000)
    assert 0 < (RS.to_tf32(x) - x).abs().max() <= x.abs().max() * 2 ** -11


def test_kmeans_reference_matches_the_port():
    from repro_torch.core.interfaces import Chunk
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB

    g = torch.Generator().manual_seed(1)
    centres = torch.nn.functional.normalize(torch.randn(40, 16, generator=g),
                                            dim=1)
    rows = torch.nn.functional.normalize(
        centres[torch.randint(40, (3000,), generator=g)]
        + 0.6 * torch.nn.functional.normalize(
            torch.randn(3000, 16, generator=g), dim=1), dim=1)
    db = TorchVectorDB(DBConfig(index_type="ivf", dim=16, capacity=4096,
                                nlist=12, nprobe=3, kmeans_iters=6,
                                train_sample=1000, use_kernel="fused"),
                       device="cpu")
    db.insert(rows, [Chunk(-1, i, "") for i in range(3000)])
    db.build_index()
    live = np.arange(3000)
    sample, init = RS.kmeans_sample(live, 1000, 12)
    x64 = rows[torch.as_tensor(sample)].double()
    with RS.fp32_matmul():
        ref = RS.kmeans(x64, init, 6)
        prog = db.centroids[:, :16].double()
        assert (prog - ref).norm(dim=1).max() < 1e-5
        best = RS.objective(x64, ref)
        assert abs(best - RS.objective(x64, prog)) < 1e-6 * best
        # one round short reads a shortfall
        assert best - RS.objective(x64, RS.kmeans(x64, init, 1)) > 1e-4


def test_search_judge_over_the_port_db():
    from repro_torch.core.interfaces import Chunk
    from repro_torch.core.vectordb import DBConfig, TorchVectorDB

    g = torch.Generator().manual_seed(0)
    rows = torch.nn.functional.normalize(torch.randn(600, 16, generator=g),
                                         dim=1)
    for quant in ("none", "sq8"):
        db = TorchVectorDB(DBConfig(index_type="flat", quant=quant, dim=16,
                                    capacity=1024, flat_capacity=512,
                                    use_kernel="fused"), device="cpu")
        db.insert(rows[:500], [Chunk(-1, i, "") for i in range(500)])
        db.build_index()
        db.insert(rows[500:], [Chunk(-1, 500 + i, "") for i in range(100)])
        q = rows[:8] + 0.05 * torch.randn(8, 16, generator=g)
        res = db.search(q.numpy(), 5)
        ids = torch.as_tensor(np.stack([r.chunk_ids for r in res])).long()
        sc = torch.as_tensor(np.stack([r.scores for r in res])).double()
        vec = rows.double()
        indexed = torch.zeros(600, dtype=torch.bool)
        indexed[:500] = True
        if quant == "sq8":
            scale, codes = RS.sq8(rows, indexed)
            vec[:500] = codes[:500].double() * scale.double()
        vis = torch.ones(600, dtype=torch.bool)
        none = torch.zeros(600, dtype=torch.bool)
        ok = RS.judge(q, ids, sc, vec, vis, none)
        assert ok["invalid"] == 0 and ok["rank_gap"] == 0.0
        assert ok["score_err"] < 1e-5
        bad = ids.clone()
        bad[0, 0] = bad[0, 4]                 # a repeated id
        assert RS.judge(q, bad, sc, vec, vis, none)["invalid"] > 0
        worse = ids.clone()
        worse[1, 0] = int(torch.argmin(q[1].double() @ vec.T))
        assert RS.judge(q, worse, sc, vec, vis, none)["rank_gap"] > 0.1
