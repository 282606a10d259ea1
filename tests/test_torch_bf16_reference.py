"""The bf16 reference: a CPU path in bf16 that rounds as the card's kernels do.

On the CPU each op of ``repro_torch.kernels.ops`` takes the plain version of
the kernel that its dtype launches on the card: bf16 flash attention
``ref.attention_tiled_ref`` (keys in tiles of 64, each tile's unnormalised p
rounded to bf16 before P.V), the bf16 SSD scan ``ssd_scan_plain(round_to=
bf16)`` and the RG-LRU ``rglru_chunked_ref``. Here the tiled version is held
against the JAX model path's chunked attention at the kernel's tile, each
op's CPU branch against its plain version bit for bit, the premise that a
bf16 matmul on the CPU is one rounding of the f32 sum, and ``chip_smoke.py``'s
bf16 check at smoke configs, a CPU model in place of the card's: each kernel
op's first call replayed bit-equal, each named control over the limits, and
the MoE layer's routing read from its own forward.
Inputs come from a numpy seed (or a torch seed for the CPU-only parts).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    FLASH_TILE, attention_ref, attention_tiled_ref, rglru_chunked_ref, rglru_ref,
)
from repro_torch.kernels.rglru_scan import CHUNK
from repro_torch.launch import serve as launch_serve

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

BF16 = torch.bfloat16
# The tiled version against JAX's chunked attention at block_kv = 64 in bf16:
# the same roundings, so the outputs differ only where XLA's and PyTorch's
# f32 orders flip a rounding (read: 0.006-0.034% of outputs, a sixth of them
# more than one bf16 step apart, where cancellation made an output small:
# see test_score_order_moves_small_outputs_over_one_step). The plain
# roundings that are not the kernel's part on a third or more of the
# outputs, which shows XLA keeps the bf16 cast of p.
TILED_VS_JAX = {"differ": 2e-3, "over 1": 2e-4}
OTHER_ROUNDING_DIFFER = 0.3
# The windowed version against JAX's banded local attention, which rounds
# the normalised p (no tile of its own): max abs error, as
# tests/test_torch_local_attention.py holds bf16.
WINDOWED_VS_JAX = 2e-2


def _qkv(b, s, hq, hk, d, seed=0):
    """The same bf16 inputs for both frameworks: (jax q, k, v), (torch q, k, v)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hk, hk)]
    return (tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in arrs),
            tuple(torch.from_numpy(a).to(BF16) for a in arrs))


def _torch(j):
    return torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(BF16)


def _jax_chunked(jq, jk, jv, softcap):
    """JAX's chunked attention at the kernel's tile; S padded to a multiple of
    it (causal: no real query attends a padded key), then cut back."""
    s = jq.shape[1]
    pad = -s % FLASH_TILE
    if pad:
        jq, jk, jv = (jnp.concatenate([t, jnp.zeros((t.shape[0], pad, *t.shape[2:]), t.dtype)],
                                      axis=1) for t in (jq, jk, jv))
    o = jax_attn.chunked_causal_attention(jq, jk, jv, block_q=FLASH_TILE,
                                          block_kv=FLASH_TILE, softcap=softcap)
    return _torch(o[:, :s])


@pytest.mark.parametrize("b,s,hq,hk,d,softcap", [
    (2, 256, 8, 2, 64, 0.0),      # causal, GQA 4:1
    (1, 192, 4, 4, 128, 20.0),    # softcap
    (1, 128, 2, 1, 256, 0.0),     # D=256, GQA 2:1
    (2, 100, 4, 2, 64, 30.0),     # S not a multiple of 64
    (1, 200, 6, 2, 32, 0.0),
])
def test_tiled_plain_version_matches_jax_chunked_attention(b, s, hq, hk, d, softcap):
    (jq, jk, jv), (q, k, v) = _qkv(b, s, hq, hk, d, seed=s + d)
    ref = _jax_chunked(jq, jk, jv, softcap)
    got = chip_smoke.step_readings(torch, attention_tiled_ref(q, k, v, softcap=softcap), ref)
    assert all(got[key] <= lim for key, lim in TILED_VS_JAX.items()), got
    for other in (attention_ref(q, k, v, softcap=softcap),
                  attention_ref(q, k, v, softcap=softcap, p_dtype=BF16)):
        assert chip_smoke.step_readings(torch, other, ref)["differ"] > OTHER_ROUNDING_DIFFER


@pytest.mark.parametrize("s,window", [(128, 64), (150, 64), (100, 24)])
def test_windowed_tiled_plain_version_matches_jax_local_attention(s, window):
    (jq, jk, jv), (q, k, v) = _qkv(1, s, 4, 1, 64, seed=window)
    out = attention_tiled_ref(q, k, v, window=window)
    ref = _torch(jax_attn.local_attention(jq, jk, jv, window=window))
    assert float((out.float() - ref.float()).abs().max()) <= WINDOWED_VS_JAX
    # a window over every key is causal attention, the same tiles bit for bit
    assert torch.equal(attention_tiled_ref(q, k, v, window=s), attention_tiled_ref(q, k, v))


def test_score_order_moves_small_outputs_over_one_step():
    """A sound change of the scores' f32 summation order (D in two halves)
    flips the bf16 rounding of a few p of a row; each moves every output of
    the row by one step of that p's share, which is over one step of an
    output that cancellation made small. The share grows with S and D, as
    the card's bf16 kernel reads against the tiled version (chip_smoke.py
    phase 3, FLASH_TILED_TOL)."""
    from repro_torch.kernels import ref as ref_mod

    einsum = torch.einsum

    def split_scores(eq, a, b):
        if eq != "bqhgd,bkhd->bhgqk":
            return einsum(eq, a, b)
        h = a.shape[-1] // 2
        return einsum(eq, a[..., :h], b[..., :h]) + einsum(eq, a[..., h:], b[..., h:])

    torch.manual_seed(0)
    shares = []
    for s, d in ((512, 64), (2048, 128)):
        q, k, v = (torch.randn(1, s, h, d).to(BF16) for h in (4, 1, 1))
        base = attention_tiled_ref(q, k, v)
        ref_mod.torch.einsum = split_scores
        try:
            alt = attention_tiled_ref(q, k, v)
        finally:
            ref_mod.torch.einsum = einsum
        shares.append(chip_smoke.step_readings(torch, alt, base))
    assert 0.0 < shares[0]["differ"] < shares[1]["differ"] <= chip_smoke.FLASH_TILED_TOL["differ"]
    assert shares[1]["over 1"] > 0.0


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (20.0, 0), (0.0, 70), (30.0, 1)])
def test_flash_cpu_branch_is_the_plain_version_of_its_dtype(softcap, window):
    _, (q, k, v) = _qkv(2, 150, 4, 2, 32, seed=9)
    assert torch.equal(ops.flash_attention(q, k, v, softcap=softcap, window=window),
                       attention_tiled_ref(q, k, v, softcap=softcap, window=window))
    qf, kf, vf = (t.float() for t in (q, k, v))
    assert torch.equal(ops.flash_attention(qf, kf, vf, softcap=softcap, window=window),
                       attention_ref(qf, kf, vf, softcap=softcap, window=window))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_cpu_branch_is_the_plain_version_of_its_dtype(dtype):
    g = torch.Generator().manual_seed(4)
    b, s, h, p, ng, n, chunk = 2, 100, 4, 16, 2, 8, 32
    dt_ = getattr(torch, dtype)
    x = torch.randn((b, s, h, p), generator=g).to(dt_)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    A = -torch.exp(torch.randn((h,), generator=g) * 0.5)
    B, C = ((torch.randn((b, s, ng, n), generator=g) * 0.3).to(dt_) for _ in range(2))
    y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    y_ref, state_ref = ops.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                          round_to=BF16 if dtype == "bfloat16" else None)
    assert torch.equal(y, y_ref) and torch.equal(state, state_ref)
    if dtype == "bfloat16":     # the roundings are there: the f32 arithmetic parts
        assert not torch.equal(y, ops.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)[0])


@pytest.mark.parametrize("s", [200, 600, 1100])
def test_rglru_cpu_branch_is_the_kernels_association(s):
    """The carry folded over CHUNK-step chunks; bit-equal to the step-by-step
    recurrence while S <= 2 * CHUNK (the first carry is the first chunk's
    last h), within f32 reassociation after, where a decays slowly enough
    (recurrentgemma's a reaches 0.999) for a carry to count."""
    g = torch.Generator().manual_seed(s)
    a = torch.sigmoid(torch.randn((2, s, 32), generator=g)) * 0.01 + 0.99
    x = torch.randn((2, s, 32), generator=g)
    h = ops.rglru_recurrence(a, x)
    assert torch.equal(h, rglru_chunked_ref(a, x, CHUNK))
    step = rglru_ref(a, x)
    if s <= 2 * CHUNK:
        assert torch.equal(h, step)
    else:
        assert not torch.equal(h, step)
        assert float((h - step).abs().max()) <= 1e-5 * float(step.abs().max())


@pytest.mark.parametrize("m,k,n", [(300, 896, 4864), (300, 4864, 896), (1, 896, 151936),
                                   (300, 18432, 64)])
def test_host_bf16_matmul_rounds_the_f32_sum_once(m, k, n):
    """The premise of the bf16 reference: a bf16 matmul on the CPU is one
    rounding of the f32 sum of the same bf16 values (exact products), but
    where its f32 order flips that rounding, at the models' contractions."""
    g = torch.Generator().manual_seed(k)
    a = torch.randn((m, k), generator=g).to(BF16)
    b = (torch.randn((k, n), generator=g) / k ** 0.5).to(BF16)
    got = a @ b
    once = (a.float() @ b.float()).to(BF16)
    assert float((got == once).float().mean()) >= 0.999


def _smoke_faults():
    c = chip_smoke
    return {c.QWEN: c.qwen_faults(torch), c.MAMBA: c.mamba_faults(torch),
            c.RG: c.rglru_faults(torch), c.GRANITE: c.new_arch_faults(torch)[c.GRANITE]}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m"])
def test_bf16_replay_check_tells_the_named_controls(arch):
    """chip_smoke.py's card-vs-bf16 check at the smoke config, with a CPU
    model in bf16 in place of the card's: each kernel op's first call,
    replayed on its own inputs, is bit-equal to the sound op, and each of
    BF16_MUST_FAIL reads over CARD_VS_BF16_TOL."""
    c = chip_smoke
    torch.manual_seed(0)
    model = launch_serve.build(arch, smoke=True, device="cpu").eval()
    view, run, _, _, _ = c.check_setup(torch, model, arch)
    limits = c.CARD_VS_BF16_TOL[arch]
    sound = c.readings_of(run(view), None, limits)
    assert set(sound) == set(limits) and all(v == 0.0 for v in sound.values()), sound
    faults = _smoke_faults()[arch]
    for fault in c.BF16_MUST_FAIL[arch]:
        module, attr, fn = faults[fault]
        with c.planted_fault(module, attr, fn):
            got = c.control_readings(c.run_refused(run, view), None, limits)
        assert c.over_bf16(got, limits), (fault, got)


def test_moe_routing_reads_the_layers_own_router_probabilities():
    """The MoE check's readings against the layer's bf16 copy: zero for the
    layer itself; over MOE_BF16_TOL with the router's logits rounded to bf16
    in ``route``, and with the router's weights read in bf16 inside the
    layer's forward, which a recomputation of the probabilities from the
    parameter would not see."""
    from repro_torch.models import moe

    c = chip_smoke
    torch.manual_seed(0)
    model = launch_serve.build(c.GRANITE, smoke=True, device="cpu").eval()
    layer = next(m for m in model.modules() if type(m).__name__ == "MoE")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 128, layer.cfg.d_model), generator=g).to(BF16)
    factor = layer.cfg.moe_capacity_factor
    tol = c.MOE_BF16_TOL[c.GRANITE]
    base = c.moe_routing(torch, c.cpu_moe_copy(torch, layer), x, factor)
    sound = c.moe_readings(torch, c.moe_routing(torch, layer, x, factor), base)
    assert not c.over_moe(sound, tol) and sound["router_probs"] == 0.0, sound
    tokens = moe.moe_tokens

    def router_in_bf16(xt, router, *args):
        return tokens(xt, router.bfloat16().float(), *args)

    faults = {**c.moe_bf16_faults(torch),
              "router weights read in bf16": (moe, "moe_tokens", router_in_bf16)}
    for fault, (module, attr, fn) in faults.items():
        with c.planted_fault(module, attr, fn):
            got = c.moe_readings(torch, c.moe_routing(torch, layer, x, factor), base)
        assert got["router_probs"] > tol["router_probs"], (fault, got)
