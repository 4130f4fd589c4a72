"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.specs``, the
collective term of ``roofline.analysis``) on a ``fake`` process group with
``meta`` tensors, on the CPU.

Every family's SMOKE cells run on a fake (4, 4) mesh, and one FULL cell
(``llama3_8b`` x ``decode_32k``) on the production (16, 16) mesh. The
report's keys are held against the reference's (``repro.launch.dryrun``:
``roofline_report``'s and the run's), the per-device argument bytes
against the specs' shard sizes, and the collective term above 0.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import partition as pt
from repro_torch.launch import dryrun, specs
from repro_torch.models import api
from repro_torch.models.config import SHAPES
from repro_torch.train.train_step import TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# repro.roofline.analysis.roofline_report's keys and repro.launch.dryrun's
REF_KEYS = {"arch", "shape", "kind", "n_chips", "flops_per_chip",
            "bytes_per_chip", "collective_bytes_per_chip", "collectives",
            "compute_s", "memory_s", "memory_flash_s", "sq_bytes_per_chip",
            "collective_s", "bottleneck", "model_flops", "useful_flop_ratio",
            "roofline_fraction", "xla_flops_per_chip", "xla_bytes_per_chip",
            "per_device_bytes", "status", "mesh", "multi_pod", "lower_s",
            "compile_s"}
REF_DEVICE_KEYS = {"arguments", "outputs", "temps", "aliased"}
REF_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute"}


def _local_bytes(shape, dtype, spec, mesh_shape):
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            size //= mesh_shape[a]
        n *= size
    return n * torch.empty((), dtype=dtype).element_size()


def _leaves(tree):
    """A cache's (or its specs') leaves in one order: a spec tuple is a
    leaf, a tuple of tensors (xLSTM's sLSTM states) is not."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple) and tree and not all(
            e is None or isinstance(e, str) or (isinstance(e, tuple) and all(
                isinstance(a, str) for a in e)) for e in tree):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _expected_arguments(cfg, shape, mesh_shape):
    """Per-device argument bytes from the specs: the parameters (and for
    training the fp32 moments), the batch and the cache, each shard's."""
    mesh = SimpleNamespace(shape=mesh_shape)
    params = dict(api.build(cfg, "meta").named_parameters())
    total = sum(_local_bytes(p.shape, p.dtype, s, mesh_shape) for p, s in
                zip(params.values(), pt.param_specs(params, mesh,
                                                    cfg).values()))
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        mu = pt.opt_state_specs(params, mesh, cfg)["mu"]
        total += 2 * sum(_local_bytes(p.shape, torch.float32, mu[n],
                                      mesh_shape)
                         for n, p in params.items())
        total += 4   # AdamW's int32 step
        batch = specs.train_batch_shapes(cfg, B, S)
    else:
        batch = specs.model_batch_shapes(
            cfg, B, S if shape.kind == "prefill" else 1)
        cache = api.init_cache_shape(cfg, B, S)
        cspecs = pt.cache_specs(cache, mesh, B, S)
        # every cache leaf: KV caches, Whisper's cross K/V, the recurrent
        # states, the placed 0-d position
        total += sum(_local_bytes(t.shape, t.dtype, spec, mesh_shape)
                     for t, spec in zip(_leaves(cache), _leaves(cspecs)))
    bspecs = pt.batch_specs(batch, mesh, B)
    total += sum(_local_bytes(t.shape, t.dtype, bspecs[k], mesh_shape)
                 for k, t in batch.items())
    return total


def _check_report(r, n_chips):
    assert REF_KEYS <= set(r), REF_KEYS - set(r)
    assert r["status"] == "ok" and r["n_chips"] == n_chips
    assert REF_DEVICE_KEYS <= set(r["per_device_bytes"])
    assert set(r["collectives"]) == REF_KINDS
    assert r["collective_bytes_per_chip"] > 0 and r["collective_s"] > 0
    assert r["collective_bytes_per_chip"] == pytest.approx(
        sum(r["collectives"].values()))
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
    # no compile and no temporaries off the card: None, each with a reason
    assert r["compile_s"] is None and r["compile_s_reason"]
    assert r["per_device_bytes"]["temps"] is None
    assert r["per_device_bytes"]["temps_reason"]
    assert r["xla_flops_per_chip"] is None


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_run_cell_smoke_on_fake_4x4(tmp_path, shape_name):
    """llama3 SMOKE on a fake (4, 4) mesh: the reference's keys, one
    rank's argument bytes equal to the specs' shard sizes, a collective
    term above 0, and the record written under ``out_dir``."""
    r = dryrun.run_cell("llama3_8b", shape_name, smoke=True,
                        mesh_shape=(4, 4), mesh_axes=("data", "model"),
                        out_dir=str(tmp_path), verbose=False)
    _check_report(r, 16)
    cfg = configs.get_smoke("llama3_8b")
    assert r["per_device_bytes"]["arguments"] == _expected_arguments(
        cfg, SHAPES[shape_name], {"data": 4, "model": 4})
    assert (tmp_path / f"llama3_8b_{shape_name}_pod1.json").exists()
    assert not torch.distributed.is_initialized()


def test_run_cell_full_llama_decode_on_16x16(tmp_path):
    """One FULL cell on the production mesh: 256 ranks, the per-device
    arguments equal to the specs' shard sizes (bf16 weights, the 32k KV
    cache sharded over batch and sequence)."""
    r = dryrun.run_cell("llama3_8b", "decode_32k", out_dir=str(tmp_path),
                        verbose=False)
    _check_report(r, 256)
    assert r["mesh"] == "16x16" and r["multi_pod"] is False
    assert r["per_device_bytes"]["arguments"] == _expected_arguments(
        configs.get_config("llama3_8b"), SHAPES["decode_32k"],
        {"data": 16, "model": 16})
    # the cache is updated in place: its shard is aliased
    assert r["per_device_bytes"]["aliased"] >= 2 * 2 ** 30


def test_vlm_decode_with_mrope_on_fake_mesh():
    """The vlm backbone's decode (M-RoPE positions) lowers on a mesh."""
    r = dryrun.run_cell("qwen2_vl_72b", "decode_32k", smoke=True,
                        mesh_shape=(4, 4), mesh_axes=("data", "model"),
                        out_dir="", verbose=False)
    _check_report(r, 16)


def test_heads_not_split_by_the_model_axis(tmp_path):
    """Phi-4-mini's 24 heads on a 16-way model dim (and its 8 KV heads):
    the train cell lowers, attention's heads gathered where they do not
    split."""
    cfg = configs.get_config("phi4_mini_3_8b").replace(n_layers=1)
    with dryrun._FakeGroup(256):
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((16, 16), ("data", "model"), "cpu", "fake")
        shape = SHAPES["train_4k"]
        cell = specs.build_cell(cfg, shape, mesh)
        cost, _, _ = specs.lower_cell(cell, mesh, shape.seq_len)
    assert cost.link_bytes > 0 and cost.per_op_flops["flash_attention"] > 0


NEW_CELLS = [(arch, shape) for arch in ("qwen3_moe_30b_a3b",
                                        "granite_moe_1b_a400m",
                                        "whisper_large_v3")
             for shape in ("train_4k", "prefill_32k", "decode_32k")] + [
    (arch, shape) for arch in ("xlstm_1_3b", "zamba2_2_7b")
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,shape_name", NEW_CELLS,
                         ids=[f"{a}-{s}" for a, s in NEW_CELLS])
def test_family_cells_lower_on_fake_4x4(arch, shape_name):
    """The MoE (expert-parallel), audio, ssm and hybrid SMOKE cells on a
    fake (4, 4) mesh: each lowers with the reference's report keys and a
    collective term, and one rank's argument bytes equal the specs' shard
    sizes (parameters, moments, batch, and every cache leaf)."""
    r = dryrun.run_cell(arch, shape_name, smoke=True, mesh_shape=(4, 4),
                        mesh_axes=("data", "model"), out_dir="",
                        verbose=False)
    _check_report(r, 16)
    assert r["per_device_bytes"]["arguments"] == _expected_arguments(
        configs.get_smoke(arch), SHAPES[shape_name],
        {"data": 4, "model": 4})
    if "moe" in arch:
        # the expert dispatch: the rows gathered over "model" before it,
        # the experts' partial sums reduce-scattered (or, in decode,
        # all-reduced) after it
        assert r["n_collectives"].get("all-gather", 0) > 0
        assert r["n_collectives"].get(
            "reduce-scatter" if shape_name != "decode_32k"
            else "all-reduce", 0) > 0


def test_long_500k_skipped_for_full_attention():
    r = dryrun.run_cell("llama3_8b", "long_500k", out_dir="", verbose=False)
    assert r["status"] == "skipped"


def test_main_lists_not_ported_apart(capsys):
    """The CLI lowers a Whisper cell (its family once listed as not
    ported) and counts it as lowered."""
    dryrun.main(["--arch", "whisper_large_v3", "--shape", "decode_32k",
                 "--out", ""])
    out = capsys.readouterr().out
    assert "[whisper_large_v3 x decode_32k x 16x16] kind=decode lowered in" \
        in out
    assert "dry-run ok: 1 cells lowered, 0 skipped" in out


def test_import_starts_no_process_group():
    """Importing the dry-run, the specs and the mesh module starts no
    process group and sets no environment variable."""
    code = (
        "import os\n"
        "before = dict(os.environ)\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.specs\n"
        "import repro_torch.launch.mesh\n"
        "assert not dist.is_initialized()\n"
        "assert dict(os.environ) == before\n"
        "print('IMPORT_OK')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert "IMPORT_OK" in r.stdout, r.stdout + r.stderr


def test_train_cell_with_accumulation_lowers():
    """A micro-batched train cell: the batch's [accum, B/accum, ...]
    leaves shard their second dim, as the reference's ``batch_specs``."""
    cfg = configs.get_smoke("llama3_8b")
    shape = SHAPES["train_4k"].__class__("t", 64, 8, "train")
    with dryrun._FakeGroup(4):
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, 2), ("data", "model"), "cpu", "fake")
        cell = specs.build_cell(cfg, shape, mesh,
                                train_cfg=TrainConfig(accum_steps=2))
        assert cell.in_specs[0]["tokens"] == (None, "data", None)
        cost, _, _ = specs.lower_cell(cell, mesh, shape.seq_len)
    assert cost.link_bytes > 0
