"""The port's distribution (``repro_torch.distributed``, ``launch.mesh``, the
sharded DB's mesh path, the sharded train step) against the JAX package's,
on the CPU.

Specs are compared on the reference's mock meshes (no devices needed), for
every arch's FULL config, leaf for leaf: the port's per-layer leaves take
the reference's stacked leaf's spec with the stack dims dropped.

The multi-rank checks run 4 gloo ranks on the CPU (``distributed.spawn``:
a ``FileStore`` under ``tmp_path``, every rank joined under a time limit),
once for the module; the JAX side of the collectives runs in a subprocess
with 4 host devices, as ``tests/test_distributed.py`` runs it. Stated
tolerances: fp32 1e-5; ids exact outside near ties
(``kernels.parity.compare_topk``).
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distributed import partition as jpt
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro_torch import configs
from repro_torch.distributed import partition as pt
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.spawn import run_ranks
from repro_torch.kernels.parity import compare_topk
from repro_torch.models import api

MESH = SimpleNamespace(shape={"data": 16, "model": 16})
MESH3 = SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _ref_flat(tree):
    """``{keystr: PartitionSpec or shape leaf}`` of a reference tree."""
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _is_spec(t) -> bool:
    return isinstance(t, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in t)


def _port_leaves(tree):
    """The leaves of a port tree in the order jax flattens the reference's
    (dict keys sorted; a spec tuple is a leaf, a tuple of specs or of
    tensors is not)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return [x for v in tree for x in _port_leaves(v)]
    return [tree]


def _dropped(spec, stack):
    return tuple(spec)[len(stack):] if tuple(spec) else ()


# -- specs against the reference, every arch's FULL config -------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_equal_reference(arch):
    """param, optimizer, cache and batch specs: the port's equal the
    reference's on both mock meshes, leaf for leaf (stack dims dropped)."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jshapes = japi.get_model(jcfg).init_shape(jcfg)
    params = dict(api.build(cfg, "meta").named_parameters())
    layout = pt.stacked_layout(params, cfg)
    assert {path for path, _ in layout.values()} == set(_ref_flat(jshapes))
    B, S = 128, 32768
    jcache = japi.get_model(jcfg).init_cache_shape(jcfg, B, S)
    cache = api.init_cache_shape(cfg, B, S)
    assert [tuple(l.shape) for l in jax.tree.leaves(jcache)] == \
        [tuple(l.shape) for l in _port_leaves(cache)]
    from repro.launch.specs import model_batch_shapes as jbatch
    from repro_torch.launch.specs import model_batch_shapes as tbatch
    for mesh in (MESH, MESH3):
        ref_p = _ref_flat(jpt.param_specs(jshapes, mesh))
        ref_o = jpt.opt_state_specs(jshapes, mesh)
        ref_mu, ref_nu = _ref_flat(ref_o["mu"]), _ref_flat(ref_o["nu"])
        mine_p = pt.param_specs(params, mesh, cfg)
        mine_o = pt.opt_state_specs(params, mesh, cfg)
        assert mine_o["step"] == tuple(ref_o["step"]) == ()
        for name, (path, stack) in layout.items():
            assert mine_p[name] == _dropped(ref_p[path], stack), name
            assert mine_o["mu"][name] == _dropped(ref_mu[path], stack), name
            assert mine_o["nu"][name] == _dropped(ref_nu[path], stack), name
        ref_c = [tuple(s) for s in jax.tree.leaves(
            jpt.cache_specs(jcache, mesh, B, S),
            is_leaf=lambda x: isinstance(x, P))]
        assert [tuple(s) for s in _port_leaves(
            pt.cache_specs(cache, mesh, B, S))] == ref_c
        for b, s in ((256, 4096), (32, 1)):
            jb, tb = jbatch(jcfg, b, s), tbatch(cfg, b, s)
            ref_b = {k: tuple(v) for k, v in jpt.batch_specs(
                jb, mesh, b).items()}
            assert pt.batch_specs(tb, mesh, b) == ref_b


def test_train_state_specs_place_err_as_reference():
    """With compression the residual ``err`` takes ``zero_spec`` of each
    parameter's spec, as the reference places it."""
    cfg = configs.get_config("llama3_8b")
    params = dict(api.build(cfg, "meta").named_parameters())
    specs = pt.train_state_specs({"params": params, "err": params}, MESH,
                                 cfg)
    assert specs["err"] == specs["opt"]["mu"]
    assert specs["err"]["layers.0.attn.wq"] == (("data"), "model")


# -- the reference's own assertions (tests/test_distributed.py,
#    tests/test_perf_opts.py), held against the port ------------------------


def _full_specs(arch):
    cfg = configs.get_config(arch)
    params = dict(api.build(cfg, "meta").named_parameters())
    return cfg, params, pt.param_specs(params, MESH, cfg)


def test_megatron_rules_on_llama():
    _, _, specs = _full_specs("llama3_8b")
    assert specs["layers.0.attn.wq"] == (None, "model")     # column parallel
    assert specs["layers.0.attn.wo"] == ("model", None)     # row parallel
    assert specs["layers.0.mlp.w_up"] == (None, "model")
    assert specs["layers.0.mlp.w_down"] == ("model", None)
    assert specs["embed"] == ("model", None)                # vocab parallel
    assert specs["lm_head"] == (None, "model")
    assert specs["final_norm"] == ()                         # replicated


def test_moe_expert_parallel():
    _, _, specs = _full_specs("qwen3_moe_30b_a3b")
    assert specs["layers.0.moe.w_gate"] == ("model", None, None)  # 128 / 16
    assert specs["layers.0.moe.w_down"] == ("model", None, None)


def test_zero_shards_optimizer_moments():
    cfg, params, _ = _full_specs("llama3_8b")
    mu = pt.opt_state_specs(params, MESH, cfg)["mu"]["layers.0.attn.wq"]
    # TP sharding kept + the largest free dim sharded over data
    assert "model" in mu and "data" in mu


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_all_archs_have_some_model_sharding(arch):
    """Every arch shards more than 25 % of its parameter bytes over TP."""
    _, params, specs = _full_specs(arch)
    total = sharded = 0
    for name, p in params.items():
        b = p.numel() * p.element_size()
        total += b
        sharded += b if "model" in str(specs[name]) else 0
    assert sharded / total > 0.25, sharded / total


def test_cache_specs_shard_batch_and_seq():
    cfg = configs.get_config("llama3_8b")
    cache = api.init_cache_shape(cfg, 128, 32768)
    k = pt.cache_specs(cache, MESH3, 128, 32768)["k"]    # [L, B, S, kv, hd]
    assert k[1] == ("pod", "data")
    assert k[2] == "model"


def test_cache_spec_prefers_trailing_dim_on_tie():
    shapes = {"C": torch.empty((6, 7, 128, 4, 1024, 1024), device="meta")}
    specs = pt.cache_specs(shapes, MESH, batch=128, max_len=4096)
    assert specs["C"] == (None, None, "data", None, None, "model")


def test_slstm_params_replicated():
    _, _, specs = _full_specs("xlstm_1_3b")
    slstm = {n: s for n, s in specs.items() if n.startswith("slstm.")}
    assert slstm and all(s == () for s in slstm.values())


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "zamba2_2_7b"])
def test_long_context_decode_state_is_bounded(arch):
    """long_500k eligibility: the decode state does not grow with the
    history (recurrent state; Zamba2's window KV bounded by its window)."""
    cfg = configs.get_smoke(arch)

    def n_elems(tree, skip_window=False):
        total = 0
        for key, leaf in _named_leaves(tree):
            if skip_window and key in ("k", "v"):
                continue
            total += leaf.numel()
        return total

    small = api.init_cache_shape(cfg, 2, 128)
    big = api.init_cache_shape(cfg, 2, 4096)
    if arch == "zamba2_2_7b":
        assert n_elems(big) / n_elems(small) < 2.0
    else:
        assert n_elems(big) == n_elems(small)


def _named_leaves(tree, key=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, key)
    else:
        yield key, tree


def test_full_attention_archs_skip_long_500k():
    assert not configs.supports_shape(configs.get_config("llama3_8b"),
                                      "long_500k")
    assert configs.supports_shape(configs.get_config("xlstm_1_3b"),
                                  "long_500k")
    assert configs.supports_shape(configs.get_config("zamba2_2_7b"),
                                  "long_500k")
    assert set(configs.all_configs()) == set(configs.ARCH_IDS)
    for arch in configs.ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert configs.supports_shape(configs.get_config(arch), shape) \
                == jconfigs.supports_shape(jconfigs.get_config(arch), shape)


# -- logical specs and placements ----------------------------------------------


_NAMES = [None, "batch", "seq", "embed", "heads", "kv_heads", "ff", "vocab",
          "experts", "zero", "kv_seq", "corpus"]


@pytest.mark.parametrize("mesh", [MESH, MESH3,
                                  SimpleNamespace(shape={"data": 4,
                                                         "model": 2})],
                         ids=["16x16", "2x16x16", "4x2"])
def test_logical_spec_equals_reference(mesh):
    """``logical_spec`` over a grid of shapes and names: the reference's
    divisibility and prefix logic, a mesh dim used once."""
    rng = np.random.default_rng(0)
    dims = [1, 2, 3, 8, 16, 24, 32, 48, 64, 256, 512, 4096]
    for _ in range(400):
        nd = int(rng.integers(1, 5))
        shape = [int(rng.choice(dims)) for _ in range(nd)]
        names = [_NAMES[int(rng.integers(len(_NAMES)))] for _ in range(nd)]
        ref = jsh.logical_spec(shape, names, mesh)
        assert sh.logical_spec(shape, names, mesh) == tuple(ref), \
            (shape, names)
    assert sh.logical_spec((4, 8), ("batch", "seq")) == (None, None)


# -- several ranks -------------------------------------------------------------


_N, _D, _NQ, _K = 512, 32, 7, 5


def _topk_data():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((_N, _D)).astype(np.float32)
    q = vecs[:_NQ] + 0.01 * rng.standard_normal((_NQ, _D)).astype(np.float32)
    live = np.ones(_N, bool)
    live[::7] = False
    x = rng.standard_normal((4, 64)).astype(np.float32)
    err = 0.01 * rng.standard_normal((4, 64)).astype(np.float32)
    return q, vecs, live, x, err


_JAX_COLLECTIVES = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src"); sys.path.insert(0, "tests")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.launch.mesh import make_mesh
from repro.distributed.collectives import compressed_psum, make_sharded_topk
from test_torch_distributed import _topk_data, _K
q, vecs, live, x, err = _topk_data()
mesh = make_mesh((4,), ("data",))
fn, n = make_sharded_topk(mesh, k=_K, corpus_axes=("data",))
s, i = fn(jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(live))
ps = shard_map(lambda a, e: compressed_psum(a, "data", e), mesh=mesh,
               in_specs=(P("data"), P("data")), out_specs=(P(), P("data")),
               check_rep=False)
tot, new_err = ps(jnp.asarray(x), jnp.asarray(err))
np.savez(sys.argv[1], s=np.asarray(s), i=np.asarray(i), n=n,
         tot=np.asarray(tot), new_err=np.asarray(new_err))
"""


def _collectives_rank(rank):
    """Rank ``rank`` of 4: the sharded top-k, its padded local top-k and
    the compressed psum on mesh (data 4)."""
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     local_topk,
                                                     make_sharded_topk)
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("data",), "cpu")
    q, vecs, live, x, err = _topk_data()
    fn, n = make_sharded_topk(mesh, _K, ("data",))
    rows = _N // 4
    sl = slice(rank * rows, (rank + 1) * rows)
    s, i = fn(torch.from_numpy(q), torch.from_numpy(vecs[sl]),
              torch.from_numpy(live[sl]))
    # a shard smaller than k: the local top-k pads (NEG, -1)
    ps, pi = local_topk(torch.from_numpy(q[:3, :8]),
                        torch.from_numpy(vecs[:5, :8]),
                        torch.tensor([True, True, False, True, True]), 9)
    tot, new_err = compressed_psum(torch.from_numpy(x[rank]),
                                   mesh.get_group("data"),
                                   torch.from_numpy(err[rank]))
    return {"s": s.numpy(), "i": i.numpy(), "n": n, "pad": (ps.numpy(),
                                                              pi.numpy()),
            "tot": tot.numpy(), "new_err": new_err.numpy()}


def _mesh_db_rank(rank):
    """The reference's mesh-DB program (``tests/test_distributed.py``) on
    rank ``rank`` of 4: every rank holds the same DB (on the CPU) and
    searches together under mesh (data 4)."""
    from repro_torch.core.interfaces import Chunk
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharded.vectordb import ShardedDBConfig, ShardedVectorDB

    mesh = make_mesh((4,), ("data",), "cpu")
    rng = np.random.default_rng(0)
    N, d, k = 480, 32, 6
    vecs = rng.standard_normal((N, d)).astype(np.float32)
    chunks = [Chunk(chunk_id=-1, doc_id=i // 4, text=f"c{i}")
              for i in range(N)]
    q = vecs[:5] + 0.01 * rng.standard_normal((5, d)).astype(np.float32)
    db = ShardedVectorDB(ShardedDBConfig(
        n_shards=4, index_type="flat", dim=d, capacity=1024,
        corpus_axes=("data",)), device="cpu")
    db.insert(vecs, chunks)

    def texts(res):
        return [[db.get_chunk(c).text for c in r.chunk_ids if c >= 0]
                for r in res]

    out = {}
    with sharding_rules(mesh):
        res = db.search(q, k)
    out["first"] = texts(res)
    out["first_ids"] = [r.chunk_ids for r in res]
    out["first_scores"] = [r.scores for r in res]
    out["searches_1"] = db.counters["mesh_searches"]
    out["host_first"] = [r.chunk_ids for r in db.search(q, k)]
    removed = int(np.argsort(-(q @ vecs.T), axis=1)[0, 0]) // 4
    db.remove(removed)
    with sharding_rules(mesh):
        res2 = db.search(q, k)
    out["removed"] = removed
    out["second"] = texts(res2)
    out["second_ids"] = [r.chunk_ids for r in res2]
    out["searches_2"] = db.counters["mesh_searches"]
    out["host_second"] = [r.chunk_ids for r in db.search(q, k)]
    out["searches_3"] = db.counters["mesh_searches"]
    return out


_TRAIN_B, _TRAIN_S = 4, 16


def _train_cfg(arch="llama3_8b"):
    return configs.get_smoke(arch).replace(dtype="float32")


def _batch(cfg, step):
    from repro_torch.train.data import DataConfig, synthetic_batch

    b = synthetic_batch(DataConfig(seq_len=_TRAIN_S, global_batch=_TRAIN_B),
                        cfg.vocab_size, step)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _train_rank(rank, ckpt_dir, arch="llama3_8b"):
    """The sharded SMOKE step of ``arch`` on mesh (data 2, model 2), fp32:
    2 steps with a checkpoint after step 1, then a restart from it that
    runs step 2 again."""
    from repro_torch.distributed import partition as ptn
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    cfg = _train_cfg(arch)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    tcfg = TrainConfig()
    ckpt = CheckpointManager(ckpt_dir, keep=2)

    def placed(step):
        b = _batch(cfg, step)
        return ptn.distribute(b, ptn.batch_specs(b, mesh, _TRAIN_B), mesh)

    out = {"metrics": [], "restart": []}
    with sharding_rules(mesh):
        state = init_train_state(0, cfg, tcfg, "cpu", mesh)
        out["local_shapes"] = {n: tuple(p.to_local().shape)
                               for n, p in state["params"].items()}
        out["mu_local_shapes"] = {n: tuple(m.to_local().shape)
                                  for n, m in state["opt"]["mu"].items()}
        step = make_train_step(cfg, tcfg)
        for i in range(2):
            state, m = step(state, placed(i))
            out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                ckpt.save(state, 1, blocking=True)
        out["params"] = {n: p.full_tensor().detach().numpy()
                         for n, p in state["params"].items()}
        out["mu"] = {n: t.full_tensor().numpy()
                     for n, t in state["opt"]["mu"].items()}
        out["nu"] = {n: t.full_tensor().numpy()
                     for n, t in state["opt"]["nu"].items()}
        torch.distributed.barrier()
        fresh = init_train_state(1, cfg, tcfg, "cpu", mesh)
        fresh, at = ckpt.restore_latest(fresh)
        out["restored_at"] = at
        for i in range(at, 2):
            fresh, m = step(fresh, placed(i))
            out["restart"].append((float(m["loss"]), float(m["grad_norm"])))
        out["restart_params"] = {n: p.full_tensor().detach().numpy()
                                 for n, p in fresh["params"].items()}
    return out


# -- the MoE, audio, ssm and hybrid families on mesh (data 2, model 2) ------

FAMILIES = ("granite_moe_1b_a400m", "qwen3_moe_30b_a3b", "whisper_large_v3",
            "xlstm_1_3b", "zamba2_2_7b")
# each case: (arch, config changes); xLSTM once more chunkwise, and the
# MoE at capacity factor 1, where routes past an expert's capacity drop
CASES = {arch: (arch, {}) for arch in FAMILIES}
CASES["xlstm_1_3b-chunked"] = ("xlstm_1_3b", {"mlstm_chunk": 16})
CASES["granite_moe_1b_a400m-cf1"] = ("granite_moe_1b_a400m",
                                     {"capacity_factor": 1.0})
_FAM_B, _FAM_S, _FAM_STEPS = 4, 64, 4   # batch, length, decode steps


def _case_cfg(case):
    """The case's SMOKE config in fp32, in both packages."""
    import dataclasses

    arch, kw = CASES[case]
    jcfg = jconfigs.get_smoke(arch).replace(dtype="float32")
    if "capacity_factor" in kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **kw))
    elif kw:
        jcfg = jcfg.replace(**kw)
    from repro_torch import convert

    return jcfg, convert.model_config(jcfg)


def _fam_batch(cfg, seed, S=_FAM_S):
    """Seeded numpy inputs: token ids and labels, Whisper's frames."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(4, cfg.vocab_size, (_FAM_B, S)).astype(
        np.int32), "labels": rng.integers(4, cfg.vocab_size, (
            _FAM_B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (_FAM_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _fam_model(cfg, weights):
    """The case's model on the CPU holding ``weights`` (by name)."""
    model = api.build(cfg, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model


def _fam_serve(model, cfg, mesh=None):
    """A prefill of ``_FAM_S`` tokens and ``_FAM_STEPS`` decode steps (a
    cache of all of them, placed by ``cache_specs`` on a mesh): each
    step's logits, and the routes that MoE layers dropped in the prefill
    and in the decode steps."""
    from repro_torch.models import moe

    b = {k: torch.from_numpy(v) for k, v in _fam_batch(cfg, 7).items()}
    nxt = torch.from_numpy(np.random.default_rng(8).integers(
        4, cfg.vocab_size, (_FAM_B, _FAM_STEPS)).astype(np.int32))
    n = _FAM_S + _FAM_STEPS
    cache = model.init_cache(_FAM_B, n)
    if mesh is not None:
        cache = pt.distribute(cache, pt.cache_specs(
            api.init_cache_shape(cfg, _FAM_B, n), mesh, _FAM_B, n), mesh)
        b, nxt = pt.distribute((b, nxt), pt.batch_specs(
            (b, nxt), mesh, _FAM_B), mesh)
    extra = (b["frames"],) if cfg.family == "audio" else ()
    out, drops = [], {}
    with torch.no_grad():
        with moe.count_drops() as d:
            lg, cache = model.prefill(b["tokens"], cache, *extra)
        out.append(lg)
        drops["prefill"] = dict(d)
        with moe.count_drops() as d:
            for i in range(_FAM_STEPS):
                lg, cache = model.decode_step(nxt[:, i:i + 1], cache)
                out.append(lg)
        drops["decode"] = dict(d)
    return [(t.full_tensor() if sh.is_dtensor(t) else t).numpy()
            for t in out], drops


def _fam_train(state, cfg, step_fn, mesh=None):
    """Two train steps: metrics, parameters and moments after them."""
    out = {"metrics": []}
    for i in range(2):
        b = {k: torch.from_numpy(v) for k, v in _fam_batch(cfg, i).items()}
        if mesh is not None:
            b = pt.distribute(b, pt.batch_specs(b, mesh, _FAM_B), mesh)
        state, m = step_fn(state, b)
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))

    def full(t):
        return (t.full_tensor() if sh.is_dtensor(t) else t).detach().numpy()

    for key, tree in (("params", state["params"]),
                      ("mu", state["opt"]["mu"]),
                      ("nu", state["opt"]["nu"])):
        out[key] = {n: full(t) for n, t in tree.items()}
    return out


def _families_rank(rank, weights_dir):
    """Every case on mesh (data 2, model 2) from the reference's weights:
    two train steps (with the local shards' shapes) and the serve run."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                              shard_model, train_state)

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for case in CASES:
        _, cfg = _case_cfg(case)
        weights = torch.load(os.path.join(weights_dir, f"{case}.pt"))
        with sh.sharding_rules(mesh):
            state = train_state(_fam_model(cfg, weights), TrainConfig(),
                                mesh)
            rec = {"local_shapes": {n: tuple(p.to_local().shape)
                                    for n, p in state["params"].items()},
                   "mu_local_shapes": {
                       n: tuple(m.to_local().shape)
                       for n, m in state["opt"]["mu"].items()}}
            rec.update(_fam_train(state, cfg,
                                  make_train_step(cfg, TrainConfig()), mesh))
            model = _fam_model(cfg, weights)
            model.requires_grad_(False)
            shard_model(model, mesh, pt.param_specs(
                dict(model.named_parameters()), mesh, cfg))
            rec["serve"], rec["drops"] = _fam_serve(model, cfg, mesh)
        out[case] = rec
    return out


def _all_ranks(rank, ckpt_dir, weights_dir):
    # one thread a rank: four ranks share the host's cores, and a BLAS
    # that picks its thread count by load can sum in another order between
    # two calls, which the bit-for-bit restart would read as a difference
    torch.set_num_threads(1)
    return {"collectives": _collectives_rank(rank),
            "db": _mesh_db_rank(rank),
            "train": _train_rank(rank, ckpt_dir),
            "moe_train": _train_rank(rank, ckpt_dir + "_moe",
                                     "granite_moe_1b_a400m"),
            "families": _families_rank(rank, weights_dir)}


@pytest.fixture(scope="module")
def family_weights(tmp_path_factory):
    """Each case's reference weights (``jax.random.PRNGKey(0)``) carried
    into the port by ``convert.model_from_jax``, saved by name for the
    ranks; with the reference's loss on the first train batch."""
    import jax.numpy as jnp

    from repro_torch import convert

    d = tmp_path_factory.mktemp("weights")
    losses = {}
    for case in CASES:
        jcfg, cfg = _case_cfg(case)
        jm = japi.get_model(jcfg)
        params = jm.init(jax.random.PRNGKey(0), jcfg)
        model = convert.model_from_jax(params, cfg, "cpu")
        torch.save({n: p.detach().clone() for n, p in
                    model.named_parameters()}, d / f"{case}.pt")
        losses[case] = float(jm.loss_fn(params, jcfg, {
            k: jnp.asarray(v) for k, v in _fam_batch(jcfg, 0).items()}))
    return str(d), losses


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, family_weights):
    """Every multi-rank program on 4 gloo ranks, once for the module."""
    d = tmp_path_factory.mktemp("ranks")
    return run_ranks(_all_ranks, 4, str(d / "ckpt"), family_weights[0],
                     store_dir=str(d), timeout=600)


@pytest.fixture(scope="module")
def unsharded(family_weights):
    """Each case unsharded on the CPU from the same weights: its two
    train steps and its serve run."""
    from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                              train_state)

    out = {}
    for case in CASES:
        _, cfg = _case_cfg(case)
        weights = torch.load(os.path.join(family_weights[0], f"{case}.pt"))
        rec = _fam_train(train_state(_fam_model(cfg, weights),
                                     TrainConfig()), cfg,
                         make_train_step(cfg, TrainConfig()))
        rec["serve"], rec["drops"] = _fam_serve(_fam_model(cfg, weights),
                                                cfg)
        out[case] = rec
    return out


@pytest.fixture(scope="module")
def jax_collectives(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "ref.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_COLLECTIVES, str(out)],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(out))


def test_sharded_topk_equals_reference_and_exact(ranks, jax_collectives):
    """4 ranks: every rank's merged result equals the reference's
    ``make_sharded_topk`` on 4 host devices and the exact global top-k
    over the live rows."""
    q, vecs, live, _, _ = _topk_data()
    exact = np.where(live[None, :], q @ vecs.T, -np.inf)
    top = np.argsort(-exact, axis=1, kind="stable")[:, :_K]
    ref_s = np.take_along_axis(exact, top, 1).astype(np.float32)
    assert int(jax_collectives["n"]) == 4
    for r in ranks:
        c = r["collectives"]
        assert c["n"] == 4
        rule = compare_topk(jax_collectives["s"], jax_collectives["i"],
                            c["s"], c["i"], TOL)
        assert rule["violations"] == 0, rule
        assert compare_topk(ref_s, top, c["s"], c["i"], TOL)[
            "violations"] == 0


def test_local_topk_pads_when_k_exceeds_rows(ranks):
    """k larger than a shard's rows pads (NEG, -1); the live rows' ids are
    the exact top."""
    from repro_torch.distributed.collectives import NEG

    q, vecs, _, _, _ = _topk_data()
    s, i = ranks[0]["collectives"]["pad"]
    assert s.shape == (3, 9) and i.shape == (3, 9)
    assert (s[:, 4:] <= NEG / 2).all() and (i[:, 4:] == -1).all()
    ref = q[:3, :8] @ vecs[:5, :8].T
    ref[:, 2] = NEG
    assert (i[:, :4] == np.argsort(-ref, axis=1)[:, :4]).all()


def test_compressed_psum_equals_reference(ranks, jax_collectives):
    """4 ranks: the sum equals the reference's under ``shard_map`` on
    every rank, and each rank's new error its shard of the reference's."""
    for r, rec in enumerate(ranks):
        c = rec["collectives"]
        # the reference's local block is [1, 64]: the same 64 values
        np.testing.assert_allclose(c["tot"],
                                   jax_collectives["tot"].reshape(-1),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(c["new_err"],
                                   jax_collectives["new_err"][r],
                                   rtol=TOL, atol=TOL)


def test_mesh_db_program(ranks):
    """The reference's mesh-DB program: the mesh path counts its searches,
    gives the exact flat top-k, drops a removed document on the next
    search, and its ids equal the host-merge path's on every rank."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((480, 32)).astype(np.float32)
    q = vecs[:5] + 0.01 * rng.standard_normal((5, 32)).astype(np.float32)
    top = np.argsort(-(q @ vecs.T), axis=1)[:, :6]
    for r in ranks:
        db = r["db"]
        assert db["searches_1"] == 1 and db["searches_2"] == 2
        assert db["searches_3"] == 2      # no mesh: the host-side merge
        for i, got in enumerate(db["first"]):
            assert set(got) == {f"c{j}" for j in top[i]}, (i, got)
        gone = {f"c{j}" for j in range(db["removed"] * 4,
                                       db["removed"] * 4 + 4)}
        for got in db["second"]:
            assert not set(got) & gone
        for a, b in zip(db["first_ids"], db["host_first"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(db["second_ids"], db["host_second"]):
            np.testing.assert_array_equal(a, b)
    for r in ranks[1:]:
        for a, b in zip(r["db"]["first_ids"], ranks[0]["db"]["first_ids"]):
            np.testing.assert_array_equal(a, b)


def test_sharded_train_step_equals_unsharded(ranks):
    """Mesh (data 2, model 2), llama3 SMOKE in fp32: loss, grad_norm and
    the gathered parameters and moments after each step equal the
    unsharded step's on the same batches within 1e-5; the local shards'
    shapes are the specs'."""
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    cfg = _train_cfg()
    tcfg = TrainConfig()
    state = init_train_state(0, cfg, tcfg, "cpu")
    step = make_train_step(cfg, tcfg)
    want = []
    for i in range(2):
        state, m = step(state, _batch(cfg, i))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    pspecs = pt.param_specs(state["params"], mesh, cfg)
    mspecs = pt.opt_state_specs(state["params"], mesh, cfg)["mu"]

    def local(shape, spec):
        out = list(shape)
        for d, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                out[d] //= mesh.shape[a]
        return tuple(out)

    for r in ranks:
        tr = r["train"]
        np.testing.assert_allclose(tr["metrics"], want, rtol=TOL, atol=TOL)
        for n, p in state["params"].items():
            np.testing.assert_allclose(tr["params"][n], p.detach().numpy(),
                                       rtol=TOL, atol=TOL, err_msg=n)
            np.testing.assert_allclose(tr["mu"][n],
                                       state["opt"]["mu"][n].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=n)
            np.testing.assert_allclose(tr["nu"][n],
                                       state["opt"]["nu"][n].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=n)
            assert tr["local_shapes"][n] == local(p.shape, pspecs[n]), n
            assert tr["mu_local_shapes"][n] == local(p.shape, mspecs[n]), n
    assert any("data" in str(s) for s in mspecs.values())   # ZeRO-1 at work


def test_sharded_restart_bit_for_bit(ranks):
    """A checkpoint at step 1, restored on the mesh into a state drawn
    from another seed, ends bit for bit where the uninterrupted run
    ends."""
    for r in ranks:
        tr = r["train"]
        assert tr["restored_at"] == 1
        assert tr["restart"] == tr["metrics"][1:]
        for n, p in tr["params"].items():
            np.testing.assert_array_equal(tr["restart_params"][n], p,
                                          err_msg=n)


def _local_shape(shape, spec, mesh_shape):
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= mesh_shape[a]
    return tuple(out)


@pytest.mark.parametrize("case", list(CASES))
def test_family_train_step_equals_unsharded(ranks, unsharded, case):
    """Mesh (data 2, model 2) in fp32, the reference's weights: two train
    steps' loss and grad_norm, and the gathered parameters and moments
    after them, equal the unsharded port step's within 1e-5 on every
    rank (the MoE's load-balancing loss over the global batch, its
    experts split over "model"); the local shards' shapes are the
    specs'."""
    want = unsharded[case]
    _, cfg = _case_cfg(case)
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    shapes = {n: p.shape for n, p in want["params"].items()}
    pspecs = pt.param_specs({n: torch.empty(s, device="meta") for n, s in
                             shapes.items()}, mesh, cfg)
    mspecs = pt.opt_state_specs({n: torch.empty(s, device="meta") for n, s
                                 in shapes.items()}, mesh, cfg)["mu"]
    for r in ranks:
        got = r["families"][case]
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=TOL, atol=TOL)
        for key in ("params", "mu", "nu"):
            for n, v in want[key].items():
                np.testing.assert_allclose(got[key][n], v, rtol=TOL,
                                           atol=TOL, err_msg=f"{key} {n}")
        for n, s in shapes.items():
            assert got["local_shapes"][n] == _local_shape(
                s, pspecs[n], mesh.shape), n
            assert got["mu_local_shapes"][n] == _local_shape(
                s, mspecs[n], mesh.shape), n
    if cfg.moe is not None:   # expert parallelism at work
        w = pspecs["layers.0.moe.w_gate"]
        assert w == ("model", None, None), w


@pytest.mark.parametrize("case", list(CASES))
def test_family_unsharded_loss_equals_reference(family_weights, unsharded,
                                                case):
    """The unsharded port's first loss equals the reference's ``loss_fn``
    on the same weights and batch (so the sharded one does too)."""
    want = family_weights[1][case]
    got = unsharded[case]["metrics"][0][0]
    assert abs(got - want) <= TOL * abs(want), (got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_family_prefill_and_decode_equal_unsharded(ranks, unsharded, case):
    """A prefill and 4 decode steps on the mesh, the cache placed by
    ``cache_specs`` (sequence-sharded KV, recurrent states sharded as the
    reference's): every step's logits equal the unsharded model's within
    1e-5 on every rank."""
    want = unsharded[case]["serve"]
    for r in ranks:
        for i, (a, b) in enumerate(zip(r["families"][case]["serve"], want)):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=f"step {i}")


def test_moe_drops_tokens_and_sharded_routing_agrees(ranks, unsharded):
    """At capacity factor 1 the unsharded Granite SMOKE model drops routes
    in the prefill (a group is a batch row) and in decode (the group is
    the whole batch); the sharded run, whose rows are sequence-sharded and
    whose batch is split over the data ranks, routes whole groups and
    drops the same routes: the dropped counts summed over the ranks whose
    experts differ equal the unsharded ones, and the outputs equal
    (``test_family_*`` above)."""
    case = "granite_moe_1b_a400m-cf1"
    want = unsharded[case]["drops"]
    assert want["prefill"]["dropped"] > 0 and want["decode"]["dropped"] > 0
    # ranks (d, m): model rank m holds half the experts; data rank d its
    # half of the prefill's rows (decode routes the whole batch on both)
    by = [r["families"][case]["drops"] for r in ranks]
    for phase in ("prefill", "decode"):
        data_split = 2 if phase == "prefill" else 1
        got = sum(d[phase]["dropped"] for d in by) // (2 // data_split)
        assert got == want[phase]["dropped"], (phase, got, want[phase])
    assert unsharded["granite_moe_1b_a400m"]["drops"]["prefill"][
        "dropped"] == 0                       # the SMOKE factor 8 drops none


def test_moe_sharded_restart_bit_for_bit(ranks):
    """Granite's SMOKE step on the mesh, its experts split over "model":
    a checkpoint at step 1 (the expert shards gathered whole), restored
    into a state drawn from another seed, ends bit for bit where the
    uninterrupted run ends."""
    for r in ranks:
        tr = r["moe_train"]
        assert tr["restored_at"] == 1
        assert tr["restart"] == tr["metrics"][1:]
        for n, p in tr["params"].items():
            np.testing.assert_array_equal(tr["restart_params"][n], p,
                                          err_msg=n)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "zamba2_2_7b"])
def test_launch_train_on_cpu_mesh(tmp_path, arch):
    """``launch.train --mesh 2,2`` under a 4-rank launch (``torchrun
    --standalone``: gloo on the CPU) trains a SMOKE config 2 steps and
    exits 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--arch", arch, "--smoke", "--steps", "2", "--device", "cpu",
         "--mesh", "2,2", "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "trained 2 steps in " in r.stdout, r.stdout


# -- the mesh module ------------------------------------------------------------


def _mesh_checks(rank):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    out = {}
    try:
        make_mesh((2, 4), ("data", "model"), "cpu")
    except ValueError as e:
        out["shrink"] = str(e)
    try:
        make_production_mesh(device_type="cpu")
    except ValueError as e:
        out["production"] = str(e)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out["names"] = mesh.mesh_dim_names
    out["shape"] = tuple(mesh.shape)
    return out


def test_make_mesh_never_shrinks(tmp_path):
    """The world size must equal the mesh's: 4 ranks refuse a (2, 4) and
    the (16, 16) production mesh, and build (2, 2) with named dims."""
    for r in run_ranks(_mesh_checks, 4, store_dir=str(tmp_path),
                       timeout=120):
        assert "world size 4 != mesh size 8" in r["shrink"]
        assert "world size 4 != mesh size 256" in r["production"]
        assert r["names"] == ("data", "model") and r["shape"] == (2, 2)


def test_host_mesh_and_constrain_without_mesh():
    """The host mesh is (1, 1) in a group of one; ``constrain`` is the
    identity without a mesh or on one device, and raises on a plain tensor
    on a larger mesh."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from repro_torch.launch import mesh as M\n"
        "from repro_torch.distributed import sharding as sh\n"
        "assert not dist.is_initialized()\n"
        "m = M.make_host_mesh(device_type='cpu')\n"
        "assert tuple(m.shape) == (1, 1) and dist.get_world_size() == 1\n"
        "x = torch.ones(2, 3)\n"
        "assert sh.constrain(x, 'batch', 'seq') is x\n"
        "with sh.sharding_rules(m):\n"
        "    assert sh.constrain(x, 'batch', 'seq') is x\n"
        "big = type('Mesh', (), {'size': lambda self: 4})()\n"
        "with sh.sharding_rules(big):\n"
        "    try:\n"
        "        sh.constrain(x, 'batch', 'seq')\n"
        "        raise SystemExit('no error')\n"
        "    except TypeError:\n"
        "        pass\n"
        "dist.destroy_process_group()\n"
        "print('HOST_MESH_OK')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("WORLD_SIZE", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert "HOST_MESH_OK" in r.stdout, r.stdout + r.stderr


def test_placements_of_specs():
    """A spec's entries become Shard placements on the mesh dims they
    name, several dims on one tensor dim in mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sh.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        sh.placements((("data", "pod"),), mesh)


def test_remat_recomputes_under_the_forward_rules():
    """A checkpointed block's recomputation runs in the backward, on
    autograd's thread for a CUDA tensor: it sees the mesh and rules of the
    forward that first ran it (here the backward runs on another
    thread)."""
    import threading

    from repro_torch.models import layers as L

    seen = []

    def block(x):
        seen.append((sh.active_mesh(), sh.active_rules()[1]["seq"]))
        return x * x          # its backward needs x: recomputed

    mesh = object()
    x = torch.ones(3, requires_grad=True)
    with sh.sharding_rules(mesh, {"seq": None}):
        y = L.remat(block, "full", x).sum()
    t = threading.Thread(target=y.backward)
    t.start()
    t.join(30)
    assert not t.is_alive()
    assert seen == [(mesh, None), (mesh, None)]
    assert x.grad.tolist() == [2.0, 2.0, 2.0]
