"""The port's CUDA kernels on the card, against their plain versions.

These tests import no JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without an sm_90 GPU every test here skips.
"""
import dataclasses

import pytest
import torch

from repro_torch.config import get_model_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import attention_ref, rglru_chunked_ref, rglru_ref, ssd_ref
from repro_torch.kernels.rglru_scan import CHUNK as RGLRU_CHUNK
from repro_torch.kernels.rglru_scan import rglru_scan_fwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.models import build_model

# (atol, rtol) against the plain version computed in f32 on the same input
# values: f32 sums in another order; bf16 adds one output rounding.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}
# SSD scan, max abs error / max |reference| against the step-by-step oracle in
# f32 on the same input values: y in f32 as tests/test_kernels.py holds the
# Pallas kernel (1e-4); y in bf16 adds one output rounding (2^-9 of |y|); the
# final state is f32 either way.
SSD_REL_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
STATE_REL_TOL = 1e-4
# The bf16 SSD kernel's y against its plain version with the same roundings
# (ops.ssd_scan_plain(round_to=bf16), y left in f32), max abs error / max
# |reference|: the kernel's one output rounding (2^-9 of |y|), plus the
# products C B^T * L that another f32 summation order (of C B^T and of the
# cumsum) rounds to the neighbouring bf16 value (read up to 3.6e-3 at n=8).
SSD_ROUNDED_REL_TOL = 5e-3
# RG-LRU scan, max abs error against the step-by-step oracle in f32 on the same
# input values (tests/test_kernels.py holds the Pallas kernel to 1e-5).
RGLRU_TOL = 1e-5


@pytest.fixture
def cuda_sm90():
    """The card the kernels are built for; decided here, never at import."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU (sm_90)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,s,hq,hk,d", [(4, 512, 16, 16, 64), (2, 1000, 8, 2, 128),
                                         (1, 100, 2, 1, 256), (2, 77, 6, 2, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_flash_attention_matches_plain_version(cuda_sm90, b, s, hq, hk, d, dtype,
                                               softcap):
    gen = torch.Generator(device=cuda_sm90).manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda_sm90)
               .to(getattr(torch, dtype)) for h in (hq, hk, hk))
    before = flash_attention_fwd.launches
    out = ops.flash_attention(q, k, v, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = attention_ref(q.float(), k.float(), v.float(), softcap=softcap)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("b,s,hq,hk,d,window", [
    (2, 700, 10, 1, 256, 100),     # recurrentgemma's GQA 10:1 at D=256, W not a multiple of 64
    (1, 1000, 10, 1, 256, 333),
    (2, 300, 4, 2, 64, 1),         # each query sees itself only
    (1, 200, 4, 2, 128, 64),       # W a multiple of the tile
    (2, 130, 4, 1, 32, 500),       # W >= S: causal
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_flash_attention_matches_plain_version(cuda_sm90, b, s, hq, hk, d, window,
                                                        dtype):
    gen = torch.Generator(device=cuda_sm90).manual_seed(3)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda_sm90)
               .to(getattr(torch, dtype)) for h in (hq, hk, hk))
    before = flash_attention_fwd.launches
    out = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref = attention_ref(q.float(), k.float(), v.float(), window=window)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)
    if window >= s:
        causal = ops.flash_attention(q, k, v)
        assert torch.equal(out, causal)


def _rglru_inputs(b, s, w, dtype, dev, seed=0):
    """a = sigmoid(N(0,1)) * 0.2 + 0.79 and b ~ N(0,1), as tests/test_kernels.py."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, s, w), generator=gen, device=dev)) * 0.2 + 0.79
    x = torch.randn((b, s, w), generator=gen, device=dev)
    return a.to(dtype), x.to(dtype)


@pytest.mark.parametrize("b,s,w", [
    (4, 4096, 2560),     # recurrentgemma-2b serving shape
    (2, 1000, 200),      # ragged S and W
    (2, 128, 256), (1, 300, 64), (3, 64, 512),   # tests/test_kernels.py's shapes
    (1, 5, 33),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_matches_plain_version(cuda_sm90, b, s, w, dtype):
    a, x = _rglru_inputs(b, s, w, getattr(torch, dtype), cuda_sm90)
    before = rglru_scan_fwd.launches
    h = ops.rglru_recurrence(a, x)
    torch.cuda.synchronize()
    assert rglru_scan_fwd.launches == before + 1
    assert h.dtype == torch.float32 and h.shape == (b, s, w)
    assert float((h - rglru_ref(a, x)).abs().max()) <= RGLRU_TOL


def test_rglru_scan_reads_strided_inputs(cuda_sm90):
    """a and b as slices of wider tensors, with a step along S of 2 rows, and
    in a layout with S minor."""
    a, x = _rglru_inputs(2, 600, 96, torch.float32, cuda_sm90, seed=1)
    for sa, sx in ((a[:, ::2, 16:80], x[:, 1::2, 8:72]),
                   (a.transpose(1, 2).contiguous().transpose(1, 2), x)):
        h = ops.rglru_recurrence(sa, sx)
        assert float((h - rglru_ref(sa, sx)).abs().max()) <= RGLRU_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_reads_strided_inputs(cuda_sm90, dtype):
    """q, k, v as column slices of one fused [B, S, 3H, D] projection."""
    gen = torch.Generator(device=cuda_sm90).manual_seed(1)
    qkv = torch.randn((2, 200, 12, 64), generator=gen, device=cuda_sm90).to(getattr(torch, dtype))
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    out = ops.flash_attention(q, k, v)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), attention_ref(q.float(), k.float(), v.float()),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 191, 257])
@pytest.mark.parametrize("window", [0, 1, 64, 65, 130])
@pytest.mark.parametrize("d,hq,hk", [(64, 4, 2), (256, 10, 1)])
def test_flash_attention_at_tile_boundaries(cuda_sm90, s, window, d, hq, hk):
    """bf16 (tensor cores: 128 query rows a block, 64 a warpgroup, key tiles
    of 64) at lengths and windows on either side of those tiles."""
    gen = torch.Generator(device=cuda_sm90).manual_seed(s * 1000 + window)
    q, k, v = (torch.randn((2, s, h, d), generator=gen, device=cuda_sm90).bfloat16()
               for h in (hq, hk, hk))
    out = ops.flash_attention(q, k, v, window=window)
    atol, rtol = TOL["bfloat16"]
    torch.testing.assert_close(out.float(), attention_ref(q.float(), k.float(), v.float(),
                                                          window=window),
                               atol=atol, rtol=rtol)
    if window >= s:
        assert torch.equal(out, ops.flash_attention(q, k, v))


def test_smoke_prefill_on_card_matches_cpu(cuda_sm90):
    """f32 qwen smoke model: the card's kernel path against the CPU's plain path."""
    cfg = dataclasses.replace(get_model_config("qwen1.5-0.5b", smoke=True),
                              act_dtype="float32", param_dtype="float32")
    gpu = build_model(cfg, device=cuda_sm90)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(0))
    before = flash_attention_fwd.launches
    _, lg = gpu.prefill(toks.to(cuda_sm90), max_len=104)
    assert flash_attention_fwd.launches - before == cfg.num_layers
    _, lc = cpu.prefill(toks, max_len=104)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)


def _ssd_inputs(b, s, h, p, g, n, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    A = -torch.exp(randn(h) * 0.5)
    B, C = (randn(b, s, g, n) * 0.3).to(dtype), (randn(b, s, g, n) * 0.3).to(dtype)
    return x, dt, A, B, C


def _rel(out, ref):
    return float((out.float() - ref).abs().max()) / (float(ref.abs().max()) + 1e-6)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (4, 2048, 32, 64, 1, 128, 128),    # mamba2-370m serving shape
    (2, 1000, 8, 64, 1, 128, 128),     # ragged S
    (2, 300, 8, 64, 2, 128, 128),      # two groups
    (2, 500, 8, 64, 1, 128, 64),       # chunk 64
    (2, 300, 4, 32, 1, 16, 32),        # mamba2 smoke shape
    (1, 77, 4, 16, 1, 8, 128),         # p 16, n 8, one short chunk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_plain_version(cuda_sm90, b, s, h, p, g, n, chunk, dtype):
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, g, n, getattr(torch, dtype), cuda_sm90)
    before = ssd_scan_fwd.launches
    y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_fwd.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert state.dtype == torch.float32 and state.shape == (b, h, n, p)
    y_ref, state_ref = ssd_ref(x.float(), dt, A, B.float(), C.float())
    assert _rel(y, y_ref) <= SSD_REL_TOL[dtype]
    assert _rel(state, state_ref) <= STATE_REL_TOL


def test_ssd_scan_reads_strided_inputs(cuda_sm90):
    """B and C as column slices of one [b, s, 2n] conv output, as the block gives them."""
    x, dt, A, _, _ = _ssd_inputs(2, 200, 8, 64, 1, 64, torch.float32, cuda_sm90, seed=1)
    bc = torch.randn((2, 200, 128), device=cuda_sm90,
                     generator=torch.Generator(device=cuda_sm90).manual_seed(2)) * 0.3
    B, C = (t.reshape(2, 200, 1, 64) for t in bc.split(64, dim=-1))
    y, state = ops.ssd_scan(x, dt, A, B, C, chunk=128)
    y_ref, state_ref = ssd_ref(x, dt, A, B, C)
    assert _rel(y, y_ref) <= SSD_REL_TOL["float32"]
    assert _rel(state, state_ref) <= STATE_REL_TOL


def test_mamba2_smoke_prefill_on_card_matches_cpu(cuda_sm90):
    """f32 mamba2 smoke model: the card's kernel path against the CPU's plain path."""
    cfg = dataclasses.replace(get_model_config("mamba2-370m", smoke=True),
                              act_dtype="float32", param_dtype="float32")
    gpu = build_model(cfg, device=cuda_sm90)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(0))
    before = ssd_scan_fwd.launches
    caches, lg = gpu.prefill(toks.to(cuda_sm90), max_len=104)
    assert ssd_scan_fwd.launches - before == cfg.num_layers
    cpu_caches, lc = cpu.prefill(toks, max_len=104)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(caches[-1]["ssm"].cpu(), cpu_caches[-1]["ssm"],
                               atol=1e-4, rtol=1e-4)


def test_recurrentgemma_smoke_prefill_on_card_matches_cpu(cuda_sm90):
    """f32 recurrentgemma smoke model (window 16, prompt 100: the band is
    real and ragged): the card's kernel path against the CPU's plain path,
    on the logits, the first layer's RG-LRU state and the local layer's ring."""
    cfg = dataclasses.replace(get_model_config("recurrentgemma-2b", smoke=True),
                              act_dtype="float32", param_dtype="float32")
    gpu = build_model(cfg, device=cuda_sm90)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(0))
    before = flash_attention_fwd.launches, rglru_scan_fwd.launches
    caches, lg = gpu.prefill(toks.to(cuda_sm90), max_len=104)
    assert (flash_attention_fwd.launches - before[0], rglru_scan_fwd.launches - before[1]) == (1, 2)
    cpu_caches, lc = cpu.prefill(toks, max_len=104)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(caches[0]["h"].cpu(), cpu_caches[0]["h"], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(caches[2]["k"].cpu(), cpu_caches[2]["k"], atol=1e-4, rtol=1e-4)


def _check_ssd_bf16(x, dt, A, B, C, chunk):
    """The bf16 kernel against the f32 oracle (the unchanged gates) and
    against the plain version with its roundings (the tighter gate)."""
    b, s, h, p = x.shape
    before = ssd_scan_fwd.launches
    y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_fwd.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert state.dtype == torch.float32 and state.shape == (b, h, B.shape[3], p)
    y_ref, state_ref = ssd_ref(x.float(), dt, A, B.float(), C.float())
    assert _rel(y, y_ref) <= SSD_REL_TOL["bfloat16"]
    assert _rel(state, state_ref) <= STATE_REL_TOL
    y_rnd, state_rnd = ops.ssd_scan_plain(x.float(), dt, A, B, C, chunk=chunk,
                                          round_to=torch.bfloat16)
    assert _rel(y, y_rnd) <= SSD_ROUNDED_REL_TOL
    assert _rel(state, state_rnd) <= STATE_REL_TOL


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (4, 2048, 32, 64, 1, 128, 128),    # mamba2-370m serving shape
    (2, 1, 4, 64, 1, 128, 128),        # S around the 128-row chunk
    (2, 127, 4, 64, 1, 128, 128),
    (2, 128, 4, 64, 1, 128, 128),
    (2, 129, 4, 64, 1, 128, 128),
    (1, 2049, 4, 64, 1, 128, 128),
    (2, 300, 4, 64, 1, 8, 128),        # n padded to a K-step of 16
    (2, 300, 4, 64, 1, 16, 128),
    (2, 300, 4, 64, 1, 64, 128),       # state rows in one warpgroup
    (1, 2048, 4, 64, 1, 128, 32),      # 64 chunks of 32 carried in order
    (2, 500, 4, 64, 1, 128, 64),
    (2, 300, 4, 16, 1, 128, 128),      # p padded to the 64-column tile
    (2, 300, 4, 32, 1, 64, 128),
    (1, 200, 2, 128, 1, 128, 128),     # two tiles of p
    (2, 300, 8, 64, 2, 128, 128),      # two groups
])
def test_ssd_scan_bf16_matches_rounded_plain_version(cuda_sm90, b, s, h, p, g, n, chunk):
    """bf16 (tensor cores: 128-row chunks, 64 rows a warpgroup, 64 columns of
    p a block) at lengths, state sizes, chunks and widths around those tiles."""
    _check_ssd_bf16(*_ssd_inputs(b, s, h, p, g, n, torch.bfloat16, cuda_sm90, seed=s + n),
                    chunk)


def test_ssd_scan_bf16_reads_strided_inputs(cuda_sm90):
    """bf16 B and C as column slices of one [b, s, 2n] conv output (C at an
    offset of n = 128 elements, 256 bytes), as the block gives them."""
    x, dt, A, _, _ = _ssd_inputs(2, 300, 8, 64, 1, 128, torch.bfloat16, cuda_sm90, seed=4)
    bc = (torch.randn((2, 300, 256), device=cuda_sm90,
                      generator=torch.Generator(device=cuda_sm90).manual_seed(5)) * 0.3
          ).bfloat16()
    B, C = (t.reshape(2, 300, 1, 128) for t in bc.split(128, dim=-1))
    _check_ssd_bf16(x, dt, A, B, C, 128)


def test_ssd_scan_bf16_refuses_misaligned_inputs(cuda_sm90):
    """A bf16 view whose rows do not start on 16 bytes raises; it is never copied."""
    x, dt, A, _, _ = _ssd_inputs(1, 64, 4, 64, 1, 64, torch.bfloat16, cuda_sm90, seed=6)
    bc = torch.zeros((1, 64, 136), device=cuda_sm90, dtype=torch.bfloat16)
    B, C = bc[..., 4:68].reshape(1, 64, 1, 64), bc[..., 68:132].reshape(1, 64, 1, 64)
    before = ssd_scan_fwd.launches
    with pytest.raises(ValueError, match="16 bytes"):
        ops.ssd_scan(x, dt, A, B, C, chunk=128)
    assert ssd_scan_fwd.launches == before


@pytest.mark.parametrize("s", [1, RGLRU_CHUNK - 1, RGLRU_CHUNK, RGLRU_CHUNK + 1,
                               3 * RGLRU_CHUNK + 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_rglru_scan_at_chunk_boundaries(cuda_sm90, s, dtype, strided):
    """S on either side of the kernel's chunk of steps: within 1e-5 of the
    step-by-step recurrence, and bit-equal to the plain version with the
    kernel's association (rglru_chunked_ref)."""
    a, x = _rglru_inputs(2, 2 * s, 160, getattr(torch, dtype), cuda_sm90, seed=s)
    a, x = (a[:, ::2, 16:144], x[:, 1::2, 8:136]) if strided else (a[:, :s, :128], x[:, :s, :128])
    before = rglru_scan_fwd.launches
    h = ops.rglru_recurrence(a, x)
    torch.cuda.synchronize()
    assert rglru_scan_fwd.launches == before + 1
    assert h.dtype == torch.float32 and h.shape == (2, s, 128)
    assert float((h - rglru_ref(a, x)).abs().max()) <= RGLRU_TOL
    assert torch.equal(h, rglru_chunked_ref(a, x, RGLRU_CHUNK))


@pytest.mark.parametrize("d", [8, 192])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dims_8_and_192(cuda_sm90, d, window, dtype):
    """D=192 has its own instantiations (12 k-steps of 16); D=8 runs the
    D=16 one on zero-padded copies with the scale 8^-0.5."""
    gen = torch.Generator(device=cuda_sm90).manual_seed(d + window)
    q, k, v = (torch.randn((2, 300, h, d), generator=gen, device=cuda_sm90)
               .to(getattr(torch, dtype)) for h in (4, 2, 2))
    before = flash_attention_fwd.launches
    out = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = attention_ref(q.float(), k.float(), v.float(), window=window)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)


# Each Function's grads against autograd through its plain version on the
# same inputs, max abs error / max |reference grad|. f32: the same function
# in other summation orders. bf16: both sides round the grads to bf16, and
# the backward's recompute rounds as the JAX model path does (P to bf16
# before P.V; xdt and C B^T * L to bf16), where the plain version keeps f32:
# a few bf16 ulps (2^-8 relative each) of the largest grad.
GRAD_REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _grads(fn, inputs, cot):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, cot)


def _check_grads(fn, plain, inputs, cot, dtype):
    for g, ref in zip(_grads(fn, inputs, cot), _grads(plain, inputs, cot)):
        assert g.dtype == ref.dtype and g.shape == ref.shape
        assert bool(torch.isfinite(g).all())
        assert _rel(g, ref.float()) <= GRAD_REL_TOL[dtype]


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grads_match_plain_version(cuda_sm90, window, dtype):
    """Ragged S=300, GQA 4:2 at D=64: the kernel's forward, the banded or
    chunked recompute's backward, against autograd through attention_ref."""
    gen = torch.Generator(device=cuda_sm90).manual_seed(7)
    q, k, v, cot = (torch.randn((2, 300, h, 64), generator=gen, device=cuda_sm90)
                    .to(getattr(torch, dtype)) for h in (4, 2, 2, 4))
    before = flash_attention_fwd.launches
    _check_grads(lambda *t: ops.flash_attention(*t, window=window),
                 lambda *t: attention_ref(*t, window=window), (q, k, v), cot, dtype)
    assert flash_attention_fwd.launches == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_grads_match_plain_version(cuda_sm90, dtype):
    """Ragged S=300 (two chunks of 128 and a third of 44): grads of x, dt, A,
    B and C through y, the final state unused (the train path)."""
    x, dt, A, B, C = _ssd_inputs(2, 300, 8, 64, 1, 64, getattr(torch, dtype), cuda_sm90, seed=8)
    cot = torch.randn(x.shape, device=cuda_sm90,
                      generator=torch.Generator(device=cuda_sm90).manual_seed(9)).to(x.dtype)
    before = ssd_scan_fwd.launches
    _check_grads(lambda *t: ops.ssd_scan(*t, chunk=128)[0],
                 lambda *t: ops.ssd_scan_plain(*t, chunk=128)[0], (x, dt, A, B, C), cot, dtype)
    assert ssd_scan_fwd.launches == before + 1


@pytest.mark.parametrize("s", [1, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_recurrence_grads_match_plain_version(cuda_sm90, s, dtype):
    """The reverse recurrence runs the forward kernel on the flipped sequence:
    two launches a forward and backward."""
    a, x = _rglru_inputs(2, s, 200, getattr(torch, dtype), cuda_sm90, seed=s)
    cot = torch.randn((2, s, 200), device=cuda_sm90,
                      generator=torch.Generator(device=cuda_sm90).manual_seed(1))
    before = rglru_scan_fwd.launches
    _check_grads(ops.rglru_recurrence, rglru_ref, (a, x), cot, dtype)
    assert rglru_scan_fwd.launches == before + 2


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b"])
def test_smoke_train_step_on_card_matches_cpu(cuda_sm90, arch):
    """One f32 train step of the smoke model on the card, with the kernels,
    against the same step on the CPU's plain path: the loss and every grad;
    then clip and AdamW on the card from the CPU's grads against the CPU's
    step. (Adam divides each grad element by its own RMS, so from the card's
    own grads an element near the f32 noise may move by up to lr on one side
    and not the other; from the same grads the two steps agree to ulps.)"""
    from repro_torch.config import TrainConfig
    from repro_torch.train import SyntheticDataset, adam_update, clip_by_global_norm, init_adam
    from repro_torch.train.train_step import accumulated_grads
    cfg = dataclasses.replace(get_model_config(arch, smoke=True),
                              act_dtype="float32", param_dtype="float32")
    tc = TrainConfig(global_batch=2, seq_len=100, lr=3e-3, warmup_steps=1, total_steps=2)
    gpu = build_model(cfg, device=cuda_sm90)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batch = SyntheticDataset(cfg, tc).batch_at(0)
    before = [fn.launches for fn in (flash_attention_fwd, ssd_scan_fwd, rglru_scan_fwd)]
    mg, gg = accumulated_grads(gpu, {k: t.to(cuda_sm90) for k, t in batch.items()}, 1)
    assert any(fn.launches > b for fn, b in
               zip((flash_attention_fwd, ssd_scan_fwd, rglru_scan_fwd), before))
    mc, gc = accumulated_grads(cpu, batch, 1)
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4
    for name, g in gc.items():
        assert _rel(gg[name].cpu(), g) <= 1e-4, name

    gg, _ = clip_by_global_norm({k: g.to(cuda_sm90) for k, g in gc.items()}, tc.grad_clip)
    gc, _ = clip_by_global_norm(gc, tc.grad_clip)
    pg, pc = dict(gpu.named_parameters()), dict(cpu.named_parameters())
    adam_update(pg, gg, init_adam(pg), tc)
    adam_update(pc, gc, init_adam(pc), tc)
    for name, p in pg.items():
        assert float((p.detach().cpu() - pc[name].detach()).abs().max()) <= 1e-6, name
