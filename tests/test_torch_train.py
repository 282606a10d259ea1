"""The port's training path against the JAX package's (CPU, f32), and its
train substrate: optimizer, train step, data, checkpoints, recovery, launcher.

Weights come from the JAX init and go across through numpy
(``repro_torch.convert.params_from_jax``); batches are made with numpy and
handed to both. The loss and every gradient are compared for every arch's
smoke config under each remat policy of the port: MoE archs with the aux
losses in the loss, embedding-input archs on f32 ``embeds``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_model_config as jax_get_model_config
from repro.config.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.models.model import chunked_ce_loss as jax_chunked_ce_loss
from repro.train import optimizer as jax_opt
from repro_torch.config import ParallelConfig, TrainConfig, get_model_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rglru_scan import rglru_scan_fwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.model import chunked_ce_loss
from repro_torch.train import (
    CheckpointManager, FailureRecovery, StragglerMonitor, SyntheticDataset, adam_update,
    clip_by_global_norm, init_adam, lr_schedule, train_step,
)
from repro_torch.train.train_step import accumulated_grads

ARCHS = ["qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b", "internlm2-1.8b",
         "internvl2-2b", "musicgen-large", "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
         "deepseek-67b", "nemotron-4-340b"]
LOSS_TOL = 1e-5   # abs, f32 losses of about 5.5
# f32 gradients, max abs error / max |JAX gradient| per parameter: the same
# model in other summation orders (attention materialised against blockwise,
# a step-by-step RG-LRU against an associative scan): a few ulps of the
# largest value, amplified by the sums (read up to 5.8e-6).
GRAD_REL_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's many small ops: the suite runs
    several workers on shared cores, where eight threads each would stall."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32_cfg(mod, arch):
    return dataclasses.replace(mod(arch, smoke=True), act_dtype="float32",
                               param_dtype="float32")


def _batch(b, s, vocab, seed=0, masked=()):
    """numpy tokens and labels [b, s] (labels -1 at the ``masked`` columns)."""
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, list(masked)] = -1
    return toks[:, :-1], labels


def _torch_batch(tokens, labels):
    return {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}


def _embeds(b, s, d, seed=0):
    return np.random.default_rng(seed + 100).standard_normal((b, s, d)).astype(np.float32)


def _inputs(cfg, tokens, labels, seed=0):
    """(JAX batch, port batch) of the tokens, or of f32 embeddings [b, s, d]
    for a model of embedding inputs, with the labels."""
    if cfg.embed_inputs:
        return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                _torch_batch(tokens, labels))
    emb = _embeds(*tokens.shape, cfg.d_model, seed)
    return ({"embeds": jnp.asarray(emb), "labels": jnp.asarray(labels)},
            {"embeds": torch.from_numpy(emb), "labels": torch.from_numpy(labels).long()})


def _rel(a: torch.Tensor, ref: np.ndarray) -> float:
    return float(np.abs(a.detach().numpy() - ref).max() / (np.abs(ref).max() or 1.0))


@pytest.fixture(scope="module", params=ARCHS)
def jax_reference(request):
    """(arch, JAX f32 params as numpy, batch, JAX loss, JAX grads by port name)."""
    arch = request.param
    jcfg = _f32_cfg(jax_get_model_config, arch)
    jmodel = jax_build_model(jcfg, remat="block")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens, labels = _batch(2, 40, jcfg.vocab_size, masked=(3, 17))
    jbatch, batch = _inputs(jcfg, tokens, labels)
    (loss, jmetrics), grads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, jbatch)
    cfg = _f32_cfg(get_model_config, arch)
    grads = params_from_jax(jax.tree.map(np.asarray, grads), cfg)
    return (arch, jax.tree.map(np.asarray, jparams), batch, float(loss),
            {k: v.numpy() for k, v in grads.items()},
            {k: float(v) for k, v in jmetrics.items()})


@pytest.mark.parametrize("remat", ["none", "block", "dots"])
def test_loss_and_every_grad_match_jax(jax_reference, remat):
    arch, jparams, batch, jloss, jgrads, jmetrics = jax_reference
    cfg = _f32_cfg(get_model_config, arch)
    model = build_model(cfg, device="cpu", remat=remat)
    model.load_state_dict(params_from_jax(jparams, cfg))
    counts = [k.launches for k in (flash_attention_fwd, ssd_scan_fwd, rglru_scan_fwd)]
    loss, metrics = model.loss_fn(batch)
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    assert [k.launches for k in (flash_attention_fwd, ssd_scan_fwd, rglru_scan_fwd)] == counts
    assert abs(float(loss.detach()) - jloss) <= LOSS_TOL
    assert float(metrics["tokens"]) == 2 * 40 - 2 * 2
    for key in ("ce", "moe_lb_loss", "moe_z_loss", "moe_drop_frac"):   # JAX's metrics
        assert abs(float(metrics[key].detach()) - jmetrics[key]) <= LOSS_TOL, key
    assert set(grads) == set(jgrads)
    errs = {k: _rel(g, jgrads[k]) for k, g in grads.items()}
    assert max(errs.values()) <= GRAD_REL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_chunked_ce_loss_matches_jax():
    """Three chunks of 512 with a softcap, scattered -1 labels and a fully
    masked middle chunk: the sum, the count and both grads."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1536, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 1536)).astype(np.int32)
    labels[:, 512:1024] = -1
    labels[:, ::7] = -1
    (jtot, jcnt), jvjp = jax.vjp(lambda x_, w_: jax_chunked_ce_loss(
        x_, w_, jnp.asarray(labels), softcap=30.0), jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    tot, cnt = chunked_ce_loss(xt, wt, torch.from_numpy(labels).long(), softcap=30.0)
    gx, gw = torch.autograd.grad(tot, (xt, wt))
    assert float(cnt) == float(jcnt) == float((labels >= 0).sum())
    assert abs(float(tot) - float(jtot)) <= 1e-6 * abs(float(jtot))
    assert _rel(gx, np.asarray(jgx)) <= 1e-5 and _rel(gw, np.asarray(jgw)) <= 1e-5
    assert float(gx[:, 512:1024].abs().max()) == 0.0


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": (3,), "c": (2, 4, 6)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_adam_steps_match_jax(dtype):
    """Params and moments stored in ``dtype``, the maths in f32, as JAX."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jcfg, tcfg = JaxTrainConfig(**cfg), TrainConfig(**cfg)
    params = _tree(0, dtype)
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in params.items()}
    jst, tst = jax_opt.init_adam(jp, dtype), init_adam(tp, dtype)
    for step in range(3):
        g = _tree(10 + step, dtype)
        jp, jst, jm = jax_opt.adam_update(
            jp, {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}, jst, jcfg)
        tp, tst, tm = adam_update(
            tp, {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in g.items()},
            tst, tcfg)
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(tst.step) == int(jst.step) == 3
    for name in params:
        for t, j in ((tp[name], jp[name]), (tst.m[name], jst.m[name]), (tst.v[name], jst.v[name])):
            assert t.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))


def test_three_train_steps_match_jax():
    """qwen smoke, f32: three steps of loss, grad, clip and AdamW against the
    JAX package's step on the same weights and batches."""
    arch = "qwen1.5-0.5b"
    jcfg, cfg = _f32_cfg(jax_get_model_config, arch), _f32_cfg(get_model_config, arch)
    tc = dict(global_batch=2, seq_len=32, lr=3e-3, warmup_steps=1, total_steps=3)
    jtc, ttc = JaxTrainConfig(**tc), TrainConfig(**tc)
    jmodel = jax_build_model(jcfg, remat="block")
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))

    @jax.jit
    def jstep(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(params, batch)
        grads, gnorm = jax_opt.clip_by_global_norm(grads, jtc.grad_clip)
        params, opt, _ = jax_opt.adam_update(params, grads, opt, jtc)
        return params, opt, loss, gnorm

    jopt, topt = jax_opt.init_adam(jparams), init_adam(dict(model.named_parameters()))
    for step in range(3):
        tokens, labels = _batch(2, 32, cfg.vocab_size, seed=20 + step)
        jparams, jopt, jloss, jnorm = jstep(
            jparams, jopt, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
        topt, metrics = train_step(model, topt, _torch_batch(tokens, labels),
                                   ParallelConfig(), ttc)
        assert abs(float(metrics["loss"]) - float(jloss)) <= LOSS_TOL
        assert abs(float(metrics["grad_norm"]) - float(jnorm)) <= 1e-5 * float(jnorm)
    ref = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    # Adam divides each grad element by its own running RMS: an element whose
    # grad is near the f32 noise of the sums moves by up to lr a step on one
    # side and not the other. No element may end more than 1% of a step
    # (lr) apart for each step taken.
    tol = 3 * 0.01 * tc["lr"]
    for name, p in model.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) <= tol, name


def test_adam_first_step_matches_reference():
    cfg = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.0)
    params = {"w": torch.ones(4)}
    st = init_adam(params)
    new_p, _, _ = adam_update(params, {"w": torch.full((4,), 0.5)}, st, cfg)
    lr1 = float(lr_schedule(cfg, 1))
    torch.testing.assert_close(new_p["w"], torch.full((4,), 1.0 - lr1), rtol=1e-4, atol=0)


def test_lr_schedule_shape_and_values():
    cfg = TrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = JaxTrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, s)) for s in range(0, 101, 5)]
    assert lrs[0] < lrs[2]                       # warmup rising
    assert max(lrs) <= 1e-3 + 1e-9
    assert lrs[-1] < 0.2 * max(lrs)              # decayed
    jlrs = [float(jax_opt.lr_schedule(jcfg, jnp.int32(s))) for s in range(0, 101, 5)]
    np.testing.assert_allclose(lrs, jlrs, rtol=1e-6, atol=0)


def test_grad_clip():
    clipped, norm = clip_by_global_norm({"a": torch.full((3,), 100.0)}, 1.0)
    assert abs(float(clipped["a"].square().sum().sqrt()) - 1.0) < 1e-5
    assert float(norm) > 100.0


def test_microbatches_equal_one_batch():
    """Two micro-batches of 2 rows: the mean of their grads is the 4-row
    batch's grad (no masked labels: each micro-batch has as many tokens)."""
    cfg = _f32_cfg(get_model_config, "mamba2-370m")
    model = build_model(cfg, device="cpu")
    batch = _torch_batch(*_batch(4, 24, cfg.vocab_size, seed=5))
    m1, g1 = accumulated_grads(model, batch, 1)
    m2, g2 = accumulated_grads(model, batch, 2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-6
    for k in g1:
        assert g2[k].dtype == torch.float32
        assert _rel(g2[k], g1[k].numpy()) <= 1e-5, k


# ------------------------- data -------------------------

def test_data_deterministic_and_seekable():
    cfg = get_model_config("qwen1.5-0.5b", smoke=True)
    tc = TrainConfig(global_batch=4, seq_len=64, seed=7)
    b1 = SyntheticDataset(cfg, tc).batch_at(13)
    b2 = SyntheticDataset(cfg, tc).batch_at(13)
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"], b2["labels"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert not torch.equal(b1["tokens"], SyntheticDataset(cfg, tc).batch_at(14)["tokens"])
    other_seed = SyntheticDataset(cfg, dataclasses.replace(tc, seed=8)).batch_at(13)
    assert not torch.equal(b1["tokens"], other_seed["tokens"])
    assert b1["tokens"].shape == (4, 64) and int(b1["tokens"].max()) < cfg.vocab_size


def test_data_embeds_for_embedding_inputs():
    """A model of embedding inputs gets bf16 embeds [B, S, d] in place of the
    tokens, from their own stream of (seed, step), and the chain's labels."""
    cfg = get_model_config("musicgen-large", smoke=True)
    tc = TrainConfig(global_batch=3, seq_len=24, seed=7)
    b1 = SyntheticDataset(cfg, tc).batch_at(5)
    assert set(b1) == {"embeds", "labels"}
    assert b1["embeds"].shape == (3, 24, cfg.d_model) and b1["embeds"].dtype == torch.bfloat16
    assert b1["labels"].shape == (3, 24) and int(b1["labels"].max()) < cfg.vocab_size
    b2 = SyntheticDataset(cfg, tc).batch_at(5)
    assert torch.equal(b1["embeds"], b2["embeds"]) and torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(b1["embeds"], SyntheticDataset(cfg, tc).batch_at(6)["embeds"])
    assert abs(float(b1["embeds"].float().std()) - 1.0) < 0.1
    # the labels are the token stream's, as a token model's of the same vocab
    tok_cfg = dataclasses.replace(cfg, embed_inputs=True)
    assert torch.equal(b1["labels"], SyntheticDataset(tok_cfg, tc).batch_at(5)["labels"])


def test_data_is_learnable_markov():
    """The bigram distribution is far from uniform (there is a signal)."""
    cfg = get_model_config("qwen1.5-0.5b", smoke=True)
    toks = SyntheticDataset(cfg, TrainConfig(global_batch=8, seq_len=256)).batch_at(0)
    toks = toks["tokens"].reshape(-1).tolist()
    assert len(set(zip(toks[:-1], toks[1:]))) < 0.5 * (len(toks) - 1)


# ------------------------- checkpointing -------------------------

def _ckpt_tree():
    return {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.randn((2, 3), generator=torch.Generator().manual_seed(0))
                  .bfloat16(),
                  "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = _ckpt_tree()
    mgr.save(7, tree)
    step, restored = mgr.restore(None, tree)
    assert step == 7
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"].view(torch.int16), tree["b"]["c"].view(torch.int16))
    assert restored["b"]["step"].dtype == torch.int32 and int(restored["b"]["step"]) == 7


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.zeros(3)})
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2
    assert mgr.latest_step() == 4
    assert (tmp_path / "LATEST").read_text() == "step_000000004"


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    tree = {"a": torch.arange(10, dtype=torch.float32)}
    mgr.save(1, tree)
    mgr.wait()
    assert mgr.latest_step() == 1
    assert torch.equal(mgr.restore(1, tree)[1]["a"], tree["a"])


# ------------------------- elastic -------------------------

def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0, evict_after=2)
    for _ in range(10):
        assert mon.observe(0.1) == "ok"
    assert mon.observe(1.0) == "straggler"
    assert mon.observe(1.0) == "evict"


def test_failure_recovery_replays_from_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    calls = {"n": 0, "starts": []}

    def train_fn(start):
        calls["n"] += 1
        calls["starts"].append(start)
        for s in range(start, 10):
            if s == 5 and calls["n"] == 1:
                mgr.save(5, {"step": torch.tensor(5)})
                raise RuntimeError("simulated node failure")
        return 10

    rec = FailureRecovery(mgr, max_restarts=2)
    assert rec.run(train_fn, 0, 10) == 10
    assert calls["starts"] == [0, 5] and rec.restarts == 1


def test_failure_recovery_bounded():
    class NoCkpt:
        def latest_step(self):
            return None

    def always_fail(start):
        raise RuntimeError("boom")

    rec = FailureRecovery(NoCkpt(), max_restarts=2)
    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        rec.run(always_fail, 0, 10)


def test_failure_recovery_restores_the_checkpoint_before_replay(tmp_path):
    """With ``restore`` the replay starts on the checkpoint's state; with no
    checkpoint to go back to, the failure itself is raised."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    restored, state = [], {"x": 0}

    def train_fn(start):
        for s in range(start, 6):
            state["x"] += 1
            if s == 4 and not restored:
                raise RuntimeError("simulated node failure")
            if s == 2:
                mgr.save(3, {"x": torch.tensor(state["x"])})
        return 6

    def restore(step):
        restored.append(step)
        state["x"] = int(mgr.restore(step, {"x": torch.tensor(0)})[1]["x"])

    rec = FailureRecovery(mgr, max_restarts=1, restore=restore)
    assert rec.run(train_fn, 0, 6) == 6
    assert restored == [3] and rec.restarts == 1 and state["x"] == 6

    class NoCkpt:
        def latest_step(self):
            return None

    def fail_once(start):
        raise ValueError("simulated kernel fault")

    rec = FailureRecovery(NoCkpt(), max_restarts=3, restore=restore)
    with pytest.raises(ValueError, match="simulated kernel fault"):
        rec.run(fail_once, 0, 10)
    assert rec.restarts == 1 and restored == [3]


# ------------------------- the launcher -------------------------

def test_launch_train_on_cpu_reduces_loss(capsys):
    """Sixty steps on the Markov stream beat the first step's loss by 0.5, as
    the JAX package's test_training_reduces_loss asks of its 120."""
    res = launch_train.main(["--smoke", "--device", "cpu", "--steps", "60", "--batch", "8",
                             "--seq", "128", "--lr", "3e-3", "--ckpt-every", "0",
                             "--log-every", "30"])
    losses = [r["loss"] for r in res.history]
    assert len(losses) == 60 and res.restarts == 0 and res.final_step == 60
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert "step    60 loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "musicgen-large"])
def test_launch_train_new_archs_on_cpu(arch, capsys):
    """An MoE arch logs its aux values each step; an embedding-input arch
    trains on the dataset's embeds. Eight steps lower the loss."""
    res = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "8",
                             "--batch", "4", "--seq", "64", "--lr", "3e-3",
                             "--ckpt-every", "0"])
    losses = [r["loss"] for r in res.history]
    assert len(losses) == 8 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    out = capsys.readouterr().out
    moe = arch == "granite-moe-1b-a400m"
    assert ("lb_loss" in out) == moe and ("moe_drop_frac" in res.history[0]) == moe
    if moe:
        row = res.history[0]
        assert row["moe_lb_loss"] > 0 and row["moe_z_loss"] > 0
        assert 0.0 <= row["moe_drop_frac"] < 1.0
        # the loss holds the aux terms: router_aux_loss * lb + 1e-3 * z over ce
        extra = 0.01 * row["moe_lb_loss"] + 1e-3 * row["moe_z_loss"]
        assert row["loss"] == pytest.approx(row["ce"] + extra, rel=1e-5)


def test_launch_train_full_width_needs_a_workload():
    """The archs too large for one card train with --smoke only."""
    for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-67b", "nemotron-4-340b"):
        with pytest.raises(ValueError, match="does not train on one card"):
            launch_train.setup(arch, device="meta")


def test_launch_train_resumes_from_its_checkpoint(tmp_path):
    argv = ["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "40", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = launch_train.main(argv + ["--steps", "4"])
    assert first.final_step == 4 and CheckpointManager(str(tmp_path)).latest_step() == 4
    second = launch_train.main(argv + ["--steps", "6"])
    assert [r["step"] for r in second.history] == [5, 6]
    assert int(second.opt_state.step) == 6


def _fail_after_step(monkeypatch, at_call: int):
    """launch.train's step (``make_train_step``'s step on its mesh) runs in
    full (params and moments updated in place) and then raises, once, on its
    ``at_call``-th call."""
    from repro_torch.train.train_step import ShardedStep
    real, calls = ShardedStep.__call__, {"n": 0}

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        calls["n"] += 1
        if calls["n"] == at_call:
            raise RuntimeError("simulated fault after the update")
        return out

    monkeypatch.setattr(ShardedStep, "__call__", faulty)


def test_launch_train_replays_a_failed_step_from_its_checkpoint(tmp_path, monkeypatch):
    """A step that fails after updating its state in place is replayed from
    the checkpoint's params and moments: the run ends where an unbroken one does."""
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32", "--steps", "5",
            "--ckpt-every", "2", "--log-every", "5"]
    clean = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "clean")])
    _fail_after_step(monkeypatch, at_call=4)
    broken = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "broken")])
    assert clean.restarts == 0 and broken.restarts == 1 and broken.final_step == 5
    assert [r["step"] for r in broken.history] == [1, 2, 3, 3, 4, 5]
    want = dict(clean.model.named_parameters())
    for name, p in broken.model.named_parameters():
        assert torch.equal(p, want[name]), name
    for moment in ("m", "v"):
        got, ref = getattr(broken.opt_state, moment), getattr(clean.opt_state, moment)
        assert all(torch.equal(got[name], ref[name]) for name in ref), moment


def test_launch_train_without_checkpoints_raises_a_failed_step(monkeypatch):
    _fail_after_step(monkeypatch, at_call=2)
    with pytest.raises(RuntimeError, match="simulated fault after the update"):
        launch_train.main(["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
                           "--steps", "3", "--ckpt-every", "0"])


def test_launch_train_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1"])


def test_profile_train_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    from repro_torch.launch import profile_train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_train.main(["--arch", "mamba2-370m"])
