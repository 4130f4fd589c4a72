"""The port's roofline package (``repro_torch.roofline``) against the JAX
package's, on the CPU.

``retrieve`` is plain arithmetic: under the reference's ``HW`` its records
equal the reference's exactly. ``op_cost`` counts a step on ``meta``
tensors: matrix-product FLOPs exactly (2 * |result| * |contracted|), bytes
at least each operation's inputs and outputs, the attention kernels by
their registered formulas; every FULL config's forward against
``api.model_flops`` up to the terms that count leaves out.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.models import config as jconfig  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import report as jreport  # noqa: E402
from repro.roofline import retrieve as jretrieve  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.models.moe import expert_capacity  # noqa: E402
from repro_torch.roofline import analysis, op_cost, report, retrieve  # noqa: E402,E501

SHAPES_RETRIEVE = [
    dict(nq=64, n=1 << 20, d=384, k=16),
    dict(nq=64, n=1 << 20, d=384, k=16, quant="sq8"),
    dict(nq=64, n=1 << 20, d=384, k=16, index_type="ivf", nlist=1024,
         nprobe=16, bucket_cap=4096),
    dict(nq=8, n=100_000, d=128, k=10, index_type="ivf", nlist=64,
         nprobe=8),
    dict(nq=64, n=1 << 20, d=384, k=16, index_type="ivf", quant="pq",
         nlist=1024, nprobe=16, pq_m=48),
    dict(nq=1, n=5000, d=64, k=5, bn=512),
]


def _forward_cost(cfg, B, S):
    return op_cost.step_cost(cfg, ShapeConfig("forward", S, B, "prefill"))


def _tpu_hw():
    """The reference's ``HW`` as the port's (its three fields)."""
    h = janalysis.HW()
    return analysis.HW(peak_flops=h.peak_flops, hbm_bw=h.hbm_bw,
                       link_bw=h.link_bw)


@pytest.mark.parametrize("kw", SHAPES_RETRIEVE)
def test_retrieve_equals_reference_under_its_hw(kw):
    """``hbm_bytes`` (fused and not) and ``roofline`` equal the
    reference's exactly on the same shape under the reference's ``HW``."""
    s, js = retrieve.RetrieveShape(**kw), jretrieve.RetrieveShape(**kw)
    assert (s.cap_b, s.rows_scored) == (js.cap_b, js.rows_scored)
    for fused in (True, False):
        assert retrieve.hbm_bytes(s, fused) == jretrieve.hbm_bytes(js, fused)
    got = retrieve.roofline(s, _tpu_hw())
    want = jretrieve.roofline(js)
    assert dataclasses.asdict(got.pop("shape")) == \
        dataclasses.asdict(want.pop("shape"))
    assert got == want


def test_retrieve_h100_adds_the_bucket_major_scan():
    """Under ``H100`` an IVF record carries the port kernel's traffic: each
    probed bucket read once per work item of up to IVF_QUERIES queries.
    The main path's IVF16 at nprobe 8 (64 queries: 32 pairs a bucket) reads
    each bucket 4 times where a (query, probe) scan reads it 32 times; at
    IVF1024, nprobe 16, the 1,024 pairs spread one a bucket, so the reads
    are the model's (plus the ok bytes). Flat and PQ records have no port
    keys."""
    main = retrieve.RetrieveShape(nq=64, n=1 << 16, d=384, k=16,
                                  index_type="ivf", nlist=16, nprobe=8)
    r = retrieve.roofline(main)
    assert r["port_bucket_reads"] == 16 * 4
    assert r["port_fused_bytes"] < r["fused_bytes"] / 4
    assert r["port_memory_s"] == r["port_fused_bytes"] / analysis.H100.hbm_bw
    s = retrieve.RetrieveShape(**SHAPES_RETRIEVE[2])
    port = retrieve.port_hbm_bytes(s)
    pairs = s.nq * s.nprobe
    assert port["bucket_reads"] == pairs == 1024
    fused = retrieve.hbm_bytes(s, fused=True)
    assert port["total"] == fused["total"] + pairs * s.cap_b
    for kw in (SHAPES_RETRIEVE[0], SHAPES_RETRIEVE[4]):
        assert "port_fused_bytes" not in retrieve.roofline(
            retrieve.RetrieveShape(**kw))


def test_h100_and_bound():
    h = analysis.H100
    assert (h.hbm_bw, h.fp32_flops, h.peak_flops, h.int8_ops) == (
        3.35e12, 67e12, 989e12, 1979e12)
    assert [f.name for f in dataclasses.fields(analysis.HW)][:3] == [
        f.name for f in dataclasses.fields(janalysis.HW)]
    assert analysis.bound(3.35e12, 1.0) == (1.0, "bytes")
    assert analysis.bound(1.0, 989e12) == (1.0, "operations")
    assert analysis.bound(0.0, 67e12, h.fp32_flops) == (1.0, "operations")


def test_shapes_equal_reference():
    assert {n: dataclasses.asdict(s) for n, s in SHAPES.items()} == {
        n: dataclasses.asdict(s) for n, s in jconfig.SHAPES.items()}
    assert SHAPES["train_4k"].is_train and not SHAPES["decode_32k"].is_train


@pytest.mark.parametrize("M,K,N,batch", [(3, 5, 7, 0), (64, 128, 32, 0),
                                         (4, 8, 16, 3)])
def test_op_cost_matmul_flops_exact(M, K, N, batch):
    """A product's FLOPs are 2 * M * N * K (a batch times), and its bytes
    its operands and result in fp32."""
    lead = (batch,) if batch else ()
    x = torch.empty((*lead, M, K), device="meta")
    w = torch.empty((*lead, K, N), device="meta")
    cost = op_cost.analyze(lambda: x @ w)
    assert cost.flops == 2 * M * N * K * (batch or 1)
    assert cost.hbm_bytes == 4 * (batch or 1) * (M * K + K * N + M * N)


def test_op_cost_bytes_cover_the_step_io_and_skip_views():
    """Bytes are at least each input read once and each output written
    once; views (a transpose, a reshape) move nothing; a broadcast operand
    counts its stored elements."""
    x = torch.empty((16, 32), device="meta")
    w = torch.empty((64, 32), device="meta")
    b = torch.empty((64,), device="meta")

    def step():
        h = torch.relu(x @ w.t() + b)
        return h.reshape(4, 4, 64).sum()

    cost = op_cost.analyze(step)
    io = 4 * (16 * 32 + 64 * 32 + 64 + 4)
    assert cost.hbm_bytes >= io
    assert "t" not in cost.per_op_bytes and "view" not in cost.per_op_bytes
    assert cost.per_op_bytes["add"] == 4 * (16 * 64 + 64 + 16 * 64)
    assert cost.flops == 2 * 16 * 32 * 64


@pytest.mark.parametrize("S,causal,window", [(1, True, 0), (33, True, 0),
                                             (33, False, 0), (40, True, 7),
                                             (40, False, 7), (9, True, 20),
                                             (9, False, 20)])
def test_attention_formula_counts_the_visible_pairs(S, causal, window):
    """The registered formulas: 4 * B * H * dh a visible pair forward, 2.5x
    backward, the pairs those of ``ref.attention_mask``; the kernels'
    bytes their operands and results."""
    mask = ref.attention_mask(S, causal, window, "cpu")
    pairs = S * S if mask is None else int(mask.sum())
    assert op_cost.visible_pairs(S, causal, window) == pairs
    B, H, Hkv, dh = 2, 6, 2, 16
    q = torch.empty((B, H, S, dh), device="meta", requires_grad=True)
    k = torch.empty((B, Hkv, S, dh), device="meta", requires_grad=True)
    v = torch.empty((B, Hkv, S, dh), device="meta", requires_grad=True)
    from repro_torch.kernels import ops

    fwd = op_cost.analyze(lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    assert fwd.flops == 4 * B * H * dh * pairs
    # q, o and k, v, plus the fp32 lse the training forward writes
    assert fwd.hbm_bytes == 4 * (2 * B * H * S * dh + 2 * B * Hkv * S * dh
                                 + B * H * S)

    def both():
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))

    cost = op_cost.analyze(both)
    assert cost.per_op_flops["flash_attention_bwd"] == int(
        2.5 * 4 * B * H * dh * pairs)


def _weight_flops(cfg, model, B, S):
    """2 * tokens * |W| over the 2-d weights a forward multiplies by:
    Whisper's encoder and cross K/V projections over the frames, the rest
    over the tokens; Zamba2's shared block once a group; the embedding
    table is a lookup (a tied head is counted as the head); Mamba2's
    depthwise convolution is not a product."""
    total = 0
    for name, p in model.named_parameters():
        if p.dim() != 2 or name == "embed" or name.endswith("conv_w"):
            continue
        tokens = B * S
        if cfg.family == "audio" and (name.startswith("encoder.") or any(
                name.endswith(f"cross_attn.{w}") for w in ("wk", "wv"))):
            tokens = B * cfg.encoder_seq
        apps = (cfg.n_layers // cfg.shared_attn_every
                if name.startswith("shared.") else 1)
        total += 2 * tokens * p.numel() * apps
    if cfg.tie_embeddings and cfg.uses_tokens:
        total += 2 * B * S * cfg.d_model * cfg.vocab_size
    return total


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_forward_flops_on_meta_match_model_flops(arch):
    """Every FULL config's forward on ``meta`` (B 1, S 256): the 2-d
    weight products (``mm``) exactly ``_weight_flops``; for the dense and
    vlm families the whole count minus the attention kernel's equals
    ``api.model_flops`` less the embedding table (a lookup) within 1e-4
    (the norm vectors, which multiply nothing); an MoE's expert products
    (``bmm``) are its capacity slots, 2 * L * B * E * C * 3 * d * ff. The
    other families' ``bmm`` are the sequence mixing that model_flops
    leaves out (mLSTM and SSD terms, Whisper's cross attention)."""
    cfg = configs.get_config(arch)
    B, S = 1, 256
    cost = _forward_cost(cfg, B, S)
    model = api.build(cfg, device="meta")
    assert cost.per_op_flops["mm"] == _weight_flops(cfg, model, B, S)
    attn = cost.per_op_flops.get("flash_attention", 0.0)
    if cfg.family in ("dense", "vlm"):
        embed = cfg.vocab_size * cfg.d_model if cfg.uses_tokens else 0
        want = api.model_flops(cfg, B, S, "prefill") - 2 * B * S * embed
        assert abs(cost.flops - attn - want) <= 1e-4 * want
        assert attn == op_cost.attention_flops((B, cfg.n_heads, S,
                                                cfg.resolved_head_dim),
                                               True, cfg.attn_window) \
            * cfg.n_layers
    if cfg.moe is not None:
        m = cfg.moe
        want = (2 * cfg.n_layers * B * m.num_experts
                * expert_capacity(S, m) * 3 * cfg.d_model * m.expert_d_ff)
        assert cost.per_op_flops["bmm"] == want


def test_roofline_report_keys_and_terms():
    """The reference's record keys; the compute and memory terms from the
    counted cost on ``H100``; XLA's and the mesh's fields ``None`` on one
    chip; more than one chip without a lowered sharded step's cost
    raises (``launch.dryrun`` gives it)."""
    cfg = configs.get_smoke("llama3_8b")
    shape = ShapeConfig("t", 64, 2, "train")
    cost = op_cost.step_cost(cfg, shape)
    r = analysis.roofline_report(cfg, shape)
    ref_keys = {"arch", "shape", "kind", "n_chips", "flops_per_chip",
                "bytes_per_chip", "collective_bytes_per_chip", "collectives",
                "compute_s", "memory_s", "memory_flash_s",
                "sq_bytes_per_chip", "collective_s", "bottleneck",
                "model_flops", "useful_flop_ratio", "roofline_fraction",
                "xla_flops_per_chip", "xla_bytes_per_chip",
                "per_device_bytes"}
    assert set(r) == ref_keys
    assert r["flops_per_chip"] == cost.flops > r["model_flops"] > 0
    assert r["compute_s"] == cost.flops / analysis.H100.peak_flops
    assert r["memory_s"] == cost.hbm_bytes / analysis.H100.hbm_bw
    assert r["bottleneck"] in ("compute", "memory")
    for key in ("collective_s", "collectives", "xla_flops_per_chip",
                "per_device_bytes"):
        assert r[key] is None
    # the train step counts the backward and the optimizer: well above the
    # forward's weight products alone
    fwd = _forward_cost(cfg, 2, 64)
    assert cost.flops > 2.5 * fwd.per_op_flops["mm"]
    with pytest.raises(ValueError):
        analysis.roofline_report(cfg, shape, n_chips=4)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_step_cost_serving_kinds(kind):
    """Prefill and decode steps on ``meta``: the decode step's weight
    products are one token a sequence, the prefill's S."""
    cfg = configs.get_smoke("qwen3_moe_30b_a3b")
    cost = op_cost.step_cost(cfg, ShapeConfig(kind, 32, 2, kind))
    assert cost.flops > 0 and cost.hbm_bytes > 0
    r = analysis.roofline_report(cfg, ShapeConfig(kind, 32, 2, kind),
                                 cost=cost)
    assert r["flops_per_chip"] == cost.flops


def test_report_table_equals_reference():
    """The port's markdown table of records equals the reference's; a
    record without a collective term prints "-"."""
    recs = [dict(arch="a", shape="train_4k", kind="train", compute_s=0.25,
                 memory_s=0.5, collective_s=0.001, bottleneck="memory",
                 useful_flop_ratio=0.8, roofline_fraction=0.4, status="ok"),
            dict(arch="b", shape="prefill_32k", kind="prefill",
                 compute_s=0.1, memory_s=0.05, collective_s=0.0,
                 bottleneck="compute", useful_flop_ratio=0.9,
                 roofline_fraction=0.9, status="ok")]
    assert report.markdown_table(recs) == jreport.markdown_table(recs)
    recs[0]["collective_s"] = None
    assert "| - |" in report.markdown_table(recs)
