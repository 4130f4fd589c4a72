"""Carry state from the JAX package's components into the port's.

The port draws its random state (the hash embedder's table, the k-means
initial centroids) with ``torch.Generator`` where the JAX package uses
``jax.random``; the two cannot give the same numbers. To run both packages on
the same state, the reference's state goes across as numpy arrays:

* ``embedder_from_jax`` — a ``repro`` ``HashEmbedder``'s table into the
  port's ``HashEmbedder``;
* ``db_state`` / ``db_from_jax`` — a ``repro`` ``JaxVectorDB``'s vectors,
  masks, payloads, centroids, buckets and quantized state (sq8 codes and
  scale, PQ codes and codebook) into a ``TorchVectorDB``, which then builds
  its own packed mirror (fp32 rows, or PQ codes);
* ``sharded_db_state`` / ``sharded_db_from_jax`` — a ``repro``
  ``ShardedVectorDB``'s shards (each as ``db_state``), epoch and counters
  into the port's ``ShardedVectorDB``;
* ``transformer_from_jax`` — a ``repro.models.transformer`` parameter tree
  (stacked ``[L, ...]`` leaves, dense, MoE or the vlm backbone, which has
  no embedding table) into the port's per-layer ``Transformer``
  (``model_config``: the config); ``whisper_from_jax``, ``xlstm_from_jax``
  and ``zamba2_from_jax`` the other families' trees (stacked ``[L, ...]``,
  ``[G, M, ...]`` or ``[G, E, ...]`` leaves) into their per-layer models,
  and ``model_from_jax`` any family's;
  ``model_llm_from_jax``, ``engine_from_jax`` (the token-level engine's
  weights and settings), ``transformer_embedder_from_jax`` (with its
  ``proj``) and ``cross_reranker_from_jax`` (with its ``head``) carry the
  model-backed components across with it;
* ``tree_by_name`` — any tree shaped like a family's parameters (its
  gradients, AdamW's moments, the compression residual) as the port's
  ``{parameter name: fp32 tensor}``, by the same per-family mapping;
  ``train_state_from_jax`` — a ``repro.train`` train state (params,
  ``mu``, ``nu``, ``step``, ``err``) as the port's (``train.train_step``).

The arguments are read by attribute only: this module imports nothing of the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.embedder import HashEmbedder, TransformerEmbedder
from repro_torch.core.generator import ModelLLM
from repro_torch.core.interfaces import Chunk
from repro_torch.core.reranker import CrossEncoderReranker
from repro_torch.core.vectordb import DBConfig, TorchVectorDB
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.transformer import Transformer
from repro_torch.models.whisper import Whisper
from repro_torch.models.xlstm import XLSTM
from repro_torch.models.zamba2 import Zamba2
from repro_torch.serving.genengine import GenEngine, _EngineCore
from repro_torch.sharded.vectordb import ShardedDBConfig, ShardedVectorDB
from repro_torch.train.train_step import TrainConfig, train_state


def embedder_from_jax(jax_embedder) -> HashEmbedder:
    """The port's ``HashEmbedder`` with the reference's table."""
    table = np.asarray(jax_embedder.table, dtype=np.float32)
    return HashEmbedder(dim=jax_embedder.dim, vocab_size=table.shape[0],
                        table=table.copy())


def _chunk(c) -> Chunk:
    return Chunk(chunk_id=c.chunk_id, doc_id=c.doc_id, text=c.text,
                 start=c.start, end=c.end, version=c.version)


def _array(a, dtype):
    return None if a is None else np.array(a, dtype)


def db_state(jax_db) -> Dict[str, object]:
    """A ``JaxVectorDB``'s index state as numpy arrays and port payloads
    (the argument of ``TorchVectorDB.load_state``)."""
    with jax_db._mu:
        return {
            "vectors": np.array(jax_db.vectors, dtype=np.float32),
            "live": jax_db.live.copy(),
            "indexed": jax_db.indexed.copy(),
            "n_slots": int(jax_db.n_slots),
            "chunks": {int(s): _chunk(c) for s, c in jax_db.chunks.items()},
            "doc_slots": {int(d): [int(s) for s in slots]
                          for d, slots in jax_db.doc_slots.items()},
            "centroids": _array(jax_db.centroids, np.float32),
            "buckets": _array(jax_db.buckets, np.int32),
            "bucket_live": _array(jax_db.bucket_live, bool),
            "sq_codes": _array(jax_db.sq_codes, np.int8),
            "sq_scale": _array(jax_db.sq_scale, np.float32),
            "pq_codes": _array(jax_db.pq_codes, np.int32),
            "pq_codebook": _array(jax_db.pq_codebook, np.float32),
        }


def db_from_jax(jax_db, use_kernel=None, device=None) -> TorchVectorDB:
    """A ``TorchVectorDB`` with the reference's config and state.

    ``use_kernel`` replaces the reference's ladder rung when given."""
    cfg = DBConfig(**{f.name: getattr(jax_db.cfg, f.name)
                      for f in dataclasses.fields(DBConfig)})
    if use_kernel is not None:
        cfg.use_kernel = use_kernel
    db = TorchVectorDB(cfg, device=device)
    db.load_state(db_state(jax_db))
    return db


def model_config(jax_cfg) -> ModelConfig:
    """The port's ``ModelConfig`` equal to a ``repro`` one (its ``moe``
    block as the port's ``MoEConfig``)."""
    fields = dataclasses.asdict(jax_cfg)
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    return ModelConfig(**fields)


def sharded_db_state(jax_sharded_db) -> Dict[str, object]:
    """A ``repro`` ``ShardedVectorDB``'s state: every shard's ``db_state``
    (payloads keep their global chunk ids), the wrapper's epoch and
    counters (the argument of ``ShardedVectorDB.load_state``)."""
    with jax_sharded_db._mu:
        return {"shards": [db_state(sh) for sh in jax_sharded_db.shards],
                "epoch": int(jax_sharded_db._epoch),
                "counters": dict(jax_sharded_db.counters)}


def sharded_db_from_jax(jax_sharded_db, use_kernel=None,
                        device=None) -> ShardedVectorDB:
    """A ``ShardedVectorDB`` with the reference's config and state (each
    shard a ``TorchVectorDB`` holding its twin's state, which then builds
    its own packed mirror). ``use_kernel`` replaces the reference's ladder
    rung when given."""
    jcfg = jax_sharded_db.cfg
    cfg = ShardedDBConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(ShardedDBConfig)})
    if use_kernel is not None:
        cfg.use_kernel = use_kernel
    db = ShardedVectorDB(cfg, device=device)
    db.load_state(sharded_db_state(jax_sharded_db))
    return db


def _copy(dst: torch.Tensor, src) -> None:
    a = np.array(src, dtype=np.float32)
    if a.shape != tuple(dst.shape):
        raise ValueError(f"shape {a.shape} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(a))


def _copy_layer(dst, tree, index) -> None:
    """Every parameter of the module ``dst`` from the leaf of the
    reference's ``tree`` at the same path (``attn.wq`` is
    ``tree["attn"]["wq"]``), sliced at ``index`` of its stacked leading
    dims."""
    for name, p in dst.named_parameters():
        leaf = tree
        for key in name.split("."):
            leaf = leaf[key]
        _copy(p, np.asarray(leaf, np.float32)[index])


def transformer_from_jax(params, cfg: ModelConfig, device=None) -> Transformer:
    """The port's ``Transformer`` for ``cfg`` holding the reference's
    parameters (a ``repro.models.transformer.init`` tree) on ``device``
    (``None`` is the card): layer ``i`` takes slice ``i`` of every stacked
    leaf (``attn``, and ``mlp`` or an MoE's ``moe``: ``router``,
    ``w_gate``, ``w_up``, ``w_down``). Values go through fp32, so bf16
    weights arrive bit for bit."""
    model = Transformer(cfg, device=device)
    for i, blk in enumerate(model.layers):
        _copy_layer(blk, params["layers"], i)
    _copy(model.final_norm, params["final_norm"])
    if model.embed is not None:
        _copy(model.embed, params["embed"])
    if model.lm_head is not None:
        _copy(model.lm_head, params["lm_head"])
    return model


def whisper_from_jax(params, cfg: ModelConfig, device=None) -> Whisper:
    """The port's ``Whisper`` holding a ``repro.models.whisper.init``
    tree: encoder and decoder layer ``i`` take slice ``i`` of the stacked
    leaves."""
    model = Whisper(cfg, device=device)
    for key, layers in (("encoder", model.encoder),
                        ("decoder", model.decoder)):
        for i, lp in enumerate(layers):
            _copy_layer(lp, params[key], i)
    for name in ("enc_final_norm", "dec_final_norm"):
        _copy_layer(getattr(model, name), params[name], ())
    _copy(model.embed, params["embed"])
    _copy(model.lm_head, params["lm_head"])
    return model


def xlstm_from_jax(params, cfg: ModelConfig, device=None) -> XLSTM:
    """The port's ``XLSTM`` holding a ``repro.models.xlstm.init`` tree:
    mLSTM block ``g * M + j`` takes slice ``[g, j]`` of the ``[G, M, ...]``
    leaves, sLSTM block ``g`` slice ``g`` of the ``[G, ...]`` ones."""
    model = XLSTM(cfg, device=device)
    n_per = len(model.mlstm) // len(model.slstm)
    for i, lp in enumerate(model.mlstm):
        _copy_layer(lp, params["mlstm"], divmod(i, n_per))
    for g, lp in enumerate(model.slstm):
        _copy_layer(lp, params["slstm"], g)
    for name in ("embed", "final_norm", "lm_head"):
        _copy(getattr(model, name), params[name])
    return model


def zamba2_from_jax(params, cfg: ModelConfig, device=None) -> Zamba2:
    """The port's ``Zamba2`` holding a ``repro.models.zamba2.init`` tree:
    Mamba2 layer ``g * E + e`` takes slice ``[g, e]`` of the ``[G, E, ...]``
    leaves; the shared block its one set."""
    model = Zamba2(cfg, device=device)
    every = cfg.shared_attn_every
    for i, lp in enumerate(model.mamba):
        _copy_layer(lp, params["mamba"], divmod(i, every))
    _copy_layer(model.shared, params["shared"], ())
    for name in ("embed", "final_norm", "lm_head"):
        _copy(getattr(model, name), params[name])
    return model


_FROM_JAX = {"dense": transformer_from_jax, "moe": transformer_from_jax,
             "vlm": transformer_from_jax, "audio": whisper_from_jax,
             "ssm": xlstm_from_jax, "hybrid": zamba2_from_jax}


def model_from_jax(params, cfg: ModelConfig, device=None):
    """The port's model of ``cfg``'s family holding the reference's
    parameters, on ``device`` (``None`` is the card)."""
    return _FROM_JAX[cfg.family](params, cfg, device)


def model_llm_from_jax(jax_llm, device=None) -> ModelLLM:
    """A port ``ModelLLM`` with the reference's config, sizes and weights,
    on ``device`` (``None`` is the card); any family of the zoo."""
    device = resolve_device(device)
    cfg = model_config(jax_llm.cfg)
    return ModelLLM(cfg, max_prompt=jax_llm.max_prompt,
                    max_new=jax_llm.max_new, batch_size=jax_llm.batch_size,
                    device=device,
                    model=model_from_jax(jax_llm.params, cfg, device))


def engine_from_jax(jax_engine, device=None) -> GenEngine:
    """A port ``GenEngine`` with a ``repro.serving.genengine.GenEngine``'s
    config, weights and settings (slots, chunk, prefill budget, admission,
    prompt length, the ``max_new`` ceiling and its current value), on
    ``device`` (``None`` is the card); its slot pool starts empty."""
    device = resolve_device(device)
    cfg = model_config(jax_engine.cfg)
    model = transformer_from_jax(jax_engine.core.params, cfg, device)
    eng = GenEngine(core=_EngineCore(cfg, model=model),
                    slots=jax_engine.slots,
                    chunk_tokens=jax_engine.chunk_tokens,
                    prefill_chunks_per_step=jax_engine.prefill_chunks_per_step,
                    admission=jax_engine.admission,
                    max_prompt=jax_engine.max_prompt,
                    max_new=jax_engine._max_new_cap)
    eng.set_max_new(jax_engine.max_new)
    return eng


def transformer_embedder_from_jax(jax_emb, device=None) -> TransformerEmbedder:
    """A port ``TransformerEmbedder`` with the reference's encoder and
    projection, on ``device`` (``None`` is the card)."""
    device = resolve_device(device)
    cfg = model_config(jax_emb.cfg)
    emb = TransformerEmbedder(
        dim=jax_emb.dim, d_model=cfg.d_model, n_layers=cfg.n_layers,
        max_len=jax_emb.max_len, batch_size=jax_emb.batch_size,
        device=device, model=transformer_from_jax(jax_emb.params, cfg, device),
        proj=np.array(jax_emb.proj, np.float32))
    return emb


def cross_reranker_from_jax(jax_rr, device=None) -> CrossEncoderReranker:
    """A port ``CrossEncoderReranker`` with the reference's encoder and
    scoring head, on ``device`` (``None`` is the card)."""
    device = resolve_device(device)
    cfg = model_config(jax_rr.cfg)
    return CrossEncoderReranker(
        d_model=cfg.d_model, n_layers=cfg.n_layers, max_len=jax_rr.max_len,
        batch_size=jax_rr.batch_size, device=device,
        model=transformer_from_jax(jax_rr.params, cfg, device),
        head=np.array(jax_rr.head, np.float32))


def tree_by_name(tree, cfg: ModelConfig, device=None) -> Dict[str,
                                                             torch.Tensor]:
    """A tree with the structure of a ``cfg`` model's reference parameters
    (its gradients, AdamW's ``mu`` or ``nu``, the residual ``err``) as
    ``{port parameter name: tensor}``, through ``model_from_jax``'s
    mapping, in fp32 (the moments' dtype) on ``device``."""
    model = model_from_jax(tree, cfg.replace(dtype="float32"), device)
    return {n: p.detach() for n, p in model.named_parameters()}


def train_state_from_jax(state, cfg: ModelConfig, device=None) -> Dict:
    """The port's train state (``train.train_step.train_state``) holding a
    ``repro.train`` state: the params in ``cfg``'s dtype, AdamW's fp32
    ``mu`` and ``nu``, its ``step`` and, where the state has one, the
    compression residual ``err``, on ``device`` (``None`` is the card)."""
    device = resolve_device(device)
    model = model_from_jax(state["params"], cfg, device)
    out = train_state(model, TrainConfig(compress_grads="err" in state))
    for key in ("mu", "nu"):
        for name, t in tree_by_name(state["opt"][key], cfg, device).items():
            out["opt"][key][name].copy_(t)
    out["opt"]["step"] = torch.tensor(int(np.asarray(state["opt"]["step"])),
                                      dtype=torch.int32)
    if "err" in state:
        for name, t in tree_by_name(state["err"], cfg, device).items():
            out["err"][name].copy_(t)
    return out
