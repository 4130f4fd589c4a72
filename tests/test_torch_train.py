"""The port's training path (``repro_torch.train``, the families'
``loss_fn``, ``launch.train``) against the JAX package's, on the CPU.

The same seeded numpy parameters and batches go through the reference
(``jax.value_and_grad`` of its ``loss_fn``, its ``adamw_update``,
``make_train_step``) and the port (its tree carried across by
``convert.model_from_jax`` / ``train_state_from_jax``), in fp32.
Tolerances: the loss within 1e-5 relative and the gradients within rtol
1e-3 / atol 1e-5 (the sums run in another order, the port's loss over
row chunks); AdamW on identical gradients within 1e-6 (the same fp32
arithmetic, one rounding apart where an add and a multiply fuse).
The ``cuda``-marked tests run one step on the card against the CPU and
skip without one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.workload.corpus import CorpusConfig as JCorpusConfig  # noqa: E402
from repro.workload.corpus import SyntheticCorpus as JCorpus  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.workload.corpus import CorpusConfig, SyntheticCorpus  # noqa: E402,E501

LOSS_REL = 1e-5
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
OPT_TOL = 1e-6


def _batch(cfg, B=2, S=16, seed=0):
    """Seeded numpy inputs for both packages (the reference's
    ``tests/test_models.py`` batch, in fp32)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(4, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(4, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _smoke(arch, **kw):
    jcfg = jconfigs.get_smoke(arch).replace(dtype="float32", **kw)
    return jcfg, convert.model_config(jcfg)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    """Per family: the port's loss and every parameter's gradient equal
    ``jax.value_and_grad`` of the reference's ``loss_fn`` from the same
    parameters and batch."""
    jcfg, cfg = _smoke(arch)
    jm = japi.get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    loss, grads = jax.value_and_grad(lambda p: jm.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
    model = convert.model_from_jax(params, cfg, "cpu")
    model.requires_grad_(True)
    names, plist = zip(*model.named_parameters())
    got_loss = api.loss_fn(model, _torch(batch))
    got = torch.autograd.grad(got_loss, plist, allow_unused=True)
    want = convert.tree_by_name(grads, cfg, "cpu")
    assert abs(float(got_loss) - float(loss)) <= LOSS_REL * abs(float(loss))
    assert set(names) == set(want)
    for name, g in zip(names, got):
        g = torch.zeros_like(want[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def _opt_trees(rng):
    """A parameter and gradient tree of a matrix, a stacked 3-d leaf and a
    vector (decay applies to ndim >= 2 only)."""
    shapes = {"w": (6, 5), "stack": (2, 3, 4), "b": (7,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    return params, shapes


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0, 100.0])
def test_adamw_update_matches_jax(grad_scale):
    """Three AdamW steps on identical numpy gradients (small, unit and past
    the clip): parameters, ``mu``, ``nu``, the global norm and the learning
    rate equal the reference's within 1e-6."""
    rng = np.random.default_rng(int(grad_scale * 10))
    params, shapes = _opt_trees(rng)
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    tcfg = topt.AdamWConfig(**dataclasses.asdict(cfg))
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    jstate, tstate = jopt.adamw_init(jp), topt.adamw_init(tp)
    for _ in range(3):
        grads = {n: (rng.standard_normal(s) * grad_scale).astype(np.float32)
                 for n, s in shapes.items()}
        jp, jstate, jm = jopt.adamw_update(
            cfg, jp, {n: jnp.asarray(g) for n, g in grads.items()}, jstate)
        tp, tstate, tm = topt.adamw_update(
            tcfg, tp, {n: torch.from_numpy(g) for n, g in grads.items()},
            tstate)
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
        for n in shapes:
            for got, want in ((tp[n], jp[n]), (tstate["mu"][n],
                                               jstate["mu"][n]),
                              (tstate["nu"][n], jstate["nu"][n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=OPT_TOL, atol=OPT_TOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 3


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedule_matches_jax(step):
    """Warmup and cosine decay equal the reference's fp32 schedule."""
    cfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                           min_lr_frac=0.1)
    got = topt.schedule(topt.AdamWConfig(**dataclasses.asdict(cfg)), step)
    want = jopt.schedule(cfg, jnp.asarray(step))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)


def test_grad_clip_bounds_update():
    """The reference's clip test: the global norm before clipping, and an
    update of at most lr per weight (decay off)."""
    cfg = topt.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0,
                           total_steps=10, weight_decay=0.0)
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 1000.0)}
    state = topt.adamw_init(params)
    new, _, metrics = topt.adamw_update(cfg, params, grads, state)
    assert float(metrics["grad_norm"]) == pytest.approx(4000.0, rel=1e-6)
    assert float((new["w"] - 1.0).abs().max()) <= 1.0 + 1e-6


def _state(cfg, tcfg, seed=0):
    return tts.init_train_state(seed, cfg, tcfg, "cpu")


def _tbatch(cfg, step=0, b=4, s=32):
    return _torch(tdata.synthetic_batch(
        tdata.DataConfig(seq_len=s, global_batch=b), cfg.vocab_size, step))


def _params(state):
    return [p.detach().clone() for p in state["params"].values()]


def test_grad_accumulation_matches_single_batch():
    """Two micro-batches of 2 (fp32 sums, averaged) equal one batch of 4:
    loss and updated parameters within 1e-5."""
    cfg = configs.get_smoke("llama3_8b").replace(dtype="float32")
    b = _tbatch(cfg)
    out = []
    for accum, batch in ((1, b), (2, {k: v.reshape(2, 2, *v.shape[1:])
                                      for k, v in b.items()})):
        tcfg = tts.TrainConfig(accum_steps=accum)
        state, m = tts.make_train_step(cfg, tcfg)(_state(cfg, tcfg), batch)
        out.append((float(m["loss"]), _params(state)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    for a, c in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_quantize_tree_matches_jax():
    """int8 compression with error feedback on identical gradients and
    residuals: the dequantized gradients and the new residual equal the
    reference's ``_quantize_tree``."""
    rng = np.random.default_rng(4)
    grads = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in (("a", (5, 7)), ("b", (9,)))}
    err = {n: (rng.standard_normal(g.shape) * 1e-2).astype(np.float32)
           for n, g in grads.items()}
    jdeq, jerr = jts._quantize_tree({n: jnp.asarray(g) for n, g in
                                     grads.items()},
                                    {n: jnp.asarray(e) for n, e in
                                     err.items()})
    tdeq, terr = tts._quantize_tree({n: torch.from_numpy(g) for n, g in
                                     grads.items()},
                                    {n: torch.from_numpy(e) for n, e in
                                     err.items()})
    for n in grads:
        np.testing.assert_allclose(tdeq[n].numpy(), np.asarray(jdeq[n]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(terr[n].numpy(), np.asarray(jerr[n]),
                                   rtol=1e-6, atol=1e-7)


def test_compressed_grads_still_converge():
    """The reference's test: int8 + error feedback on one repeated batch,
    the loss falls by 0.1 over 8 steps and the residual stays finite."""
    cfg = configs.get_smoke("llama3_8b")
    tcfg = tts.TrainConfig(compress_grads=True, opt=topt.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=100))
    state = _state(cfg, tcfg)
    step = tts.make_train_step(cfg, tcfg)
    b = _tbatch(cfg)
    losses = []
    for _ in range(8):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses
    assert all(bool(e.isfinite().all()) for e in state["err"].values())


@pytest.mark.parametrize("arch,compress", [("llama3_8b", False),
                                           ("llama3_8b", True),
                                           ("qwen3_moe_30b_a3b", False)])
def test_train_step_matches_jax(arch, compress):
    """One ``make_train_step`` step from the same train state (the
    reference's carried across by ``train_state_from_jax``): loss, updated
    parameters and moments, and the compression residual."""
    jcfg, cfg = _smoke(arch)
    jt = jts.TrainConfig(compress_grads=compress)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    state = convert.train_state_from_jax(jstate, cfg, "cpu")
    batch = _batch(jcfg)
    jnew, jm = jts.make_train_step(jcfg, jt)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = tts.make_train_step(cfg, tts.TrainConfig(
        compress_grads=compress))(state, _torch(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_REL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    want = {"params": convert.tree_by_name(jnew["params"], cfg, "cpu"),
            "mu": convert.tree_by_name(jnew["opt"]["mu"], cfg, "cpu"),
            "nu": convert.tree_by_name(jnew["opt"]["nu"], cfg, "cpu")}
    got = {"params": new["params"], "mu": new["opt"]["mu"],
           "nu": new["opt"]["nu"]}
    # AdamW's first step moves a weight by about lr * sign(g): a gradient
    # within its error of 0 moves it by at most ~2 lr (lr 3e-6 at step 1)
    tol = {"params": dict(rtol=1e-5, atol=1e-5), "mu": GRAD_TOL,
           "nu": dict(rtol=2e-3, atol=1e-9)}
    # with compression, a gradient within its error of a rounding boundary
    # lands on the neighbouring int8 code, a step of max|g| / 127: mu moves
    # by a tenth of it, nu by at most 2/127 of the leaf's largest value, so
    # held to 2 % of the leaf's largest |want|
    for key in want:
        for n, w in want[key].items():
            g, w = got[key][n].detach().numpy(), w.numpy()
            if compress and key != "params":
                assert np.abs(g - w).max() <= 0.02 * np.abs(w).max() + 1e-9, \
                    (key, n)
            elif compress:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_allclose(g, w, err_msg=f"{key} {n}",
                                           **tol[key])
    if compress:
        err = convert.tree_by_name(jnew["err"], cfg, "cpu")
        scale = max(float(e.abs().max()) for e in err.values())
        for n, e in err.items():   # a rounding flip moves one code: scale
            assert float((new["err"][n] - e).abs().max()) <= 2 * scale


def test_data_bit_equal_to_jax():
    """Synthetic batches for several (seed, step, shard) and a corpus
    stream's batches are the reference's bit for bit."""
    for seed, step, shard, n_shards in ((0, 0, 0, 1), (7, 3, 1, 2),
                                        (3, 99, 3, 4)):
        kw = dict(seq_len=16, global_batch=8, seed=seed)
        got = tdata.synthetic_batch(tdata.DataConfig(**kw), 100, step, shard,
                                    n_shards)
        want = jdata.synthetic_batch(jdata.DataConfig(**kw), 100, step,
                                     shard, n_shards)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    kw = dict(n_docs=12, seed=5)
    tsrc = tdata.CorpusDataSource(SyntheticCorpus(CorpusConfig(**kw)),
                                  tdata.DataConfig(seq_len=24,
                                                   global_batch=4), 512)
    jsrc = jdata.CorpusDataSource(JCorpus(JCorpusConfig(**kw)),
                                  jdata.DataConfig(seq_len=24,
                                                   global_batch=4), 512)
    np.testing.assert_array_equal(tsrc.stream, jsrc.stream)
    for step in (0, 5):
        for k, v in jsrc.batch(step, 1, 2).items():
            np.testing.assert_array_equal(tsrc.batch(step, 1, 2)[k], v)
    jcfg = jconfigs.get_smoke("llama3_8b")
    it = tdata.batch_iterator(tdata.DataConfig(seq_len=8, global_batch=2),
                              convert.model_config(jcfg), start_step=2)
    jit = jdata.batch_iterator(jdata.DataConfig(seq_len=8, global_batch=2),
                               jcfg, start_step=2)
    for _ in range(2):
        a, b = next(it), next(jit)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_checkpoint_restart_bitwise_identical(tmp_path):
    """4 steps straight == 2 steps, a checkpoint, a fresh state restored
    from it, 2 more: every parameter, moment and the step bit for bit."""
    cfg = configs.get_smoke("llama3_8b")
    tcfg = tts.TrainConfig()
    step = tts.make_train_step(cfg, tcfg)
    a = _state(cfg, tcfg)
    for s in range(4):
        a, _ = step(a, _tbatch(cfg, s))
    mgr = CheckpointManager(str(tmp_path))
    b = _state(cfg, tcfg)
    for s in range(2):
        b, _ = step(b, _tbatch(cfg, s))
    mgr.save(b, 2)
    mgr.wait()
    c, at = mgr.restore_latest(_state(cfg, tcfg, seed=1))
    assert at == 2 and int(c["opt"]["step"]) == 2
    for s in range(2, 4):
        c, _ = step(c, _tbatch(cfg, s))
    assert int(c["opt"]["step"]) == int(a["opt"]["step"]) == 4
    for key in ("mu", "nu"):
        for n, t in a["opt"][key].items():
            assert torch.equal(t, c["opt"][key][n]), (key, n)
    for n, p in a["params"].items():
        assert p.dtype == torch.bfloat16 and torch.equal(p, c["params"][n])


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    """Restoring into another config's state raises before writing."""
    tcfg = tts.TrainConfig()
    state = _state(configs.get_smoke("llama3_8b"), tcfg)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(state, 1, blocking=True)
    other = _state(configs.get_smoke("phi4_mini_3_8b"), tcfg)
    before = [p.clone() for p in other["params"].values()]
    with pytest.raises((ValueError, KeyError)):
        mgr.restore(other, 1)
    assert all(torch.equal(a, b)
               for a, b in zip(before, other["params"].values()))
    for s in (2, 3, 4):
        mgr.save(state, s, blocking=True)
    assert mgr.list_checkpoints() == [3, 4]   # keep prunes the oldest


@pytest.mark.parametrize("n,mp,pod", [(8, 2, 0), (7, 2, 0), (16, 4, 8),
                                      (31, 4, 8), (4, 4, 0), (24, 2, 8),
                                      (12, 3, 16)])
def test_plan_elastic_mesh_matches_jax(n, mp, pod):
    assert dataclasses.asdict(tft.plan_elastic_mesh(n, mp, pod)) == \
        dataclasses.asdict(jft.plan_elastic_mesh(n, mp, pod))


def test_fault_tolerant_runner_checkpoints_and_stamps(tmp_path):
    """The runner steps, stamps heartbeats, records step times, saves every
    ``ckpt_every`` steps and once at the end."""
    mgr = CheckpointManager(str(tmp_path), keep=10)
    hb, sd = tft.HeartbeatTracker(n_hosts=1), tft.StragglerDetector()
    runner = tft.FaultTolerantRunner(mgr, hb, sd, ckpt_every=2)
    state = {"x": {"w": torch.zeros(3)}}

    def step_fn(st, batch):
        st["x"]["w"] += batch
        return st, {"loss": float(st["x"]["w"][0])}

    state, step, m = runner.run(state, step_fn, iter([1.0] * 10), 5)
    assert step == 5 and m["loss"] == 5.0
    assert mgr.list_checkpoints() == [2, 4, 5]
    assert hb.beats[0].step == 4 and len(sd.durations[0]) == 5


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ["llama3_8b", "qwen3_moe_30b_a3b",
                                  "zamba2_2_7b"])
def test_remat_gives_equal_gradients(arch, remat):
    """``cfg.remat`` recomputes, it does not change the function: the loss
    and every gradient under ``dots`` and ``full`` equal ``none``'s."""
    base = configs.get_smoke(arch).replace(dtype="float32", remat="none")
    model = api.get_model(base).init(base, seed=0, device="cpu")
    model.requires_grad_(True)
    batch = _torch(_batch(base))
    plist = list(model.parameters())
    want_loss = api.loss_fn(model, batch)
    want = torch.autograd.grad(want_loss, plist, allow_unused=True)
    model.cfg = base.replace(remat=remat)
    for mod in model.modules():
        if hasattr(mod, "cfg"):
            mod.cfg = model.cfg
    got_loss = api.loss_fn(model, batch)
    got = torch.autograd.grad(got_loss, plist, allow_unused=True)
    assert float(got_loss) == float(want_loss)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_remat_rejects_unknown_mode():
    with pytest.raises(ValueError):
        L.remat(lambda x: x, "sometimes", torch.zeros(1))


def test_lm_loss_chunks_equal_whole():
    """``lm_loss`` over row chunks (each recomputed in the backward) equals
    the reference's cross entropy of the whole logits, with its gradient;
    labels below 0 are skipped."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 10, 8)).astype(
        np.float32)).requires_grad_()
    head = torch.from_numpy(rng.standard_normal((8, 50)).astype(
        np.float32)).requires_grad_()
    labels = torch.from_numpy(rng.integers(-1, 50, (3, 10)))
    whole = L.token_cross_entropy(x @ head, labels)
    chunked = L.lm_loss(x, head, labels, chunk_elems=7 * 50)
    assert float(chunked) == pytest.approx(float(whole), rel=1e-6)
    for a, b in zip(torch.autograd.grad(chunked, (x, head)),
                    torch.autograd.grad(whole, (x, head))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_launch_train_smoke_cpu_loss_falls(tmp_path, capsys):
    """``launch.train --smoke --device cpu`` prints a falling loss and the
    reference's last line; relaunched, it restores its checkpoint."""
    argv = ["--arch", "llama3_8b", "--smoke", "--device", "cpu", "--steps",
            "12", "--seq-len", "32", "--global-batch", "4", "--lr", "1e-3",
            "--log-every", "1", "--ckpt-every", "6", "--ckpt-dir",
            str(tmp_path)]
    final = tlaunch.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    losses = [float(l.split("loss=")[1].split()[0]) for l in lines
              if l.startswith("step ")]
    assert len(losses) == 12 and losses[-1] < losses[0] - 0.1, losses
    assert lines[-1].startswith("trained 12 steps in ")
    assert "tok/s), final loss=" in lines[-1] and "grad_norm=" in lines[-1]
    assert final == pytest.approx(losses[-1], abs=1e-4)
    tlaunch.main(argv[:-6] + ["--steps", "14", "--log-every", "0",
                              "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 12" in out
    assert "trained 2 steps" in out


@pytest.mark.parametrize("arch", ["qwen2_vl_72b", "whisper_large_v3"])
def test_launch_train_stub_frontends(tmp_path, capsys, arch):
    """The vlm and Whisper train from the launcher on zero embeddings and
    zero frames (their stub frontends, as in serving)."""
    tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                  "2", "--seq-len", "8", "--global-batch", "2", "--accum",
                  "2", "--ckpt-dir", str(tmp_path)])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "trained 2 steps in ")


def test_launch_train_needs_the_card_unless_told():
    """No fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", "llama3_8b", "--smoke", "--steps", "1"])


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_card_equals_cpu(cuda_device, arch):
    """One fp32 SMOKE step on the card equals the CPU's from the same
    weights and batch: loss within 1e-5, updated parameters within 1e-5
    (chip_smoke.py's train phase, per family)."""
    cfg = configs.get_smoke(arch).replace(dtype="float32")
    cpu = api.get_model(cfg).init(cfg, seed=0, device="cpu")
    card = api.build(cfg, device=cuda_device)
    with torch.no_grad():
        for (_, a), (_, b) in zip(cpu.named_parameters(),
                                  card.named_parameters()):
            b.copy_(a)
    batch = _torch(_batch(cfg))
    out = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        state = tts.train_state(model, tts.TrainConfig())
        state, m = tts.make_train_step(cfg, tts.TrainConfig())(
            state, {k: v.to(dev) for k, v in batch.items()})
        out.append((float(m["loss"]), [p.detach().cpu() for p in
                                       state["params"].values()]))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5)
