"""The serve step's captured CUDA graph and the one-rank NCCL mesh step on
the card. These tests import no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_parallel_cuda.py

Without an NVIDIA GPU every test here skips.

The graph replays the eager step's kernels: tokens equal and logits within
``GRAPH_TOL`` (1e-5 of the largest logit; bit-equal expected). The mesh step
on one rank runs the plain step's arithmetic on the same local tensors:
losses and grad norms within 1e-6 relative.
"""
import dataclasses

import pytest
import torch

from repro_torch.config import ParallelConfig, TrainConfig, get_model_config
from repro_torch.models import build_model
from repro_torch.serve.decode import ServeStep, greedy_decode, make_serve_step

GRAPH_TOL = 1e-5
ARCHS = ["qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device is visible)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _prompt(cfg, b, s, dev, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)


def _copy(caches):
    return [{k: t.clone() for k, t in c.items()} for c in caches]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
def test_captured_step_matches_eager(cuda, arch, pos_kind):
    """Smoke config, bf16: 24 steps through the graph and through the eager
    step from copies of one prefill (recurrentgemma's window of 16 wraps)."""
    cfg = get_model_config(arch, smoke=True)
    model = build_model(cfg, device=cuda)
    prompt = _prompt(cfg, 2, 40, cuda)
    caches, logits = model.prefill(prompt, max_len=64)
    token = logits.argmax(-1)
    step = ServeStep(model)
    graph_caches, eager_caches = _copy(caches), _copy(caches)
    tok_g, tok_e = token, token
    for t in range(24):
        pos = 40 + t if pos_kind == "int" else torch.tensor(40 + t, device=cuda)
        graph_caches, tok_g = step(graph_caches, tok_g, pos)
        eager_caches, tok_e, lg_e = step.eager(eager_caches, tok_e, pos)
        assert torch.equal(tok_g, tok_e), (arch, t)
        diff = float((step.logits - lg_e).abs().max()) / float(lg_e.abs().max())
        assert diff <= GRAPH_TOL, (arch, t, diff)
    assert step.captures == 1
    for cg, ce in zip(graph_caches, eager_caches):
        for k in cg:
            assert torch.equal(cg[k], ce[k]), k


def test_graph_recaptured_for_new_caches(cuda):
    """One capture per (batch, cache length): the caches of a later prefill
    of that shape are copied into the graph's, with the eager steps' tokens;
    caches of another length are captured anew."""
    cfg = get_model_config("qwen1.5-0.5b", smoke=True)
    model = build_model(cfg, device=cuda)
    step = ServeStep(model)
    for seed, max_len, captures in ((1, 24, 1), (2, 24, 1), (3, 32, 2)):
        caches, logits = model.prefill(_prompt(cfg, 2, 16, cuda, seed), max_len=max_len)
        eager = _copy(caches)
        got, _ = greedy_decode(model, caches, logits.argmax(-1), 16, 4, step=step)
        want, _ = greedy_decode(model, eager, logits.argmax(-1), 16, 4, graph=False)
        assert torch.equal(got, want), seed
        assert step.captures == captures, seed
    assert step.caches[0]["v"].shape[1] == 32


def test_one_rank_nccl_mesh_step_matches_plain_step(cuda):
    """Two steps of qwen's smoke config (f32) through make_train_step on a
    one-rank NCCL mesh and through the plain train_step, from one seed."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.train import SyntheticDataset, init_adam, train_step
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_model_config("qwen1.5-0.5b", smoke=True),
                              act_dtype="float32", param_dtype="float32")
    par, tc = ParallelConfig(data=1, model=1), TrainConfig(global_batch=4, seq_len=128,
                                                           total_steps=2, warmup_steps=1)
    data = SyntheticDataset(cfg, tc, device=cuda)
    a = build_model(cfg, device=cuda)
    b = build_model(cfg, device=cuda)
    _, _, jit_step, _ = make_train_step(a, par, tc, make_mesh_for(par, cuda))
    sstep = jit_step(dict(a.named_parameters()))
    params, opt_a = sstep.place(dict(a.named_parameters()), init_adam(dict(a.named_parameters())))
    opt_b = init_adam(dict(b.named_parameters()))
    for i in range(2):
        params, opt_a, ma = sstep(params, opt_a, data.batch_at(i))
        opt_b, mb = train_step(b, opt_b, data.batch_at(i), par, tc)
        for k in ("loss", "grad_norm"):
            assert abs(float(ma[k]) - float(mb[k])) <= 1e-6 * abs(float(mb[k])), (i, k)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert float((p.detach() - q.detach()).abs().max()) <= 1e-6, n


def test_failed_capture_raises(cuda, monkeypatch):
    """A step that reads a device value on the host cannot be captured: the
    step raises, and nothing falls back to eager steps. (Last in the file: a
    failed capture may leave the context unusable.)"""
    cfg = get_model_config("qwen1.5-0.5b", smoke=True)
    model = build_model(cfg, device=cuda)
    caches, logits = model.prefill(_prompt(cfg, 2, 16, cuda), max_len=24)
    real = model.decode_step

    def syncing(caches, inputs, pos):
        caches, out = real(caches, inputs, pos)
        if float(out.sum()) != float(out.sum()):      # a host read of the logits
            raise AssertionError("nan")
        return caches, out

    monkeypatch.setattr(model, "decode_step", syncing)
    step, _, _ = make_serve_step(model, ParallelConfig(data=1, model=1), None, 2, 24)
    with pytest.raises(RuntimeError):
        step(caches, logits.argmax(-1), 16)
