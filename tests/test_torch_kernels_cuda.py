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
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import build_model

# (atol, rtol) against the plain version computed in f32 on the same input
# values: f32 sums in another order; bf16 adds one output rounding.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}


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


def test_flash_attention_reads_strided_inputs(cuda_sm90):
    """q, k, v as column slices of one fused [B, S, 3H, D] projection."""
    gen = torch.Generator(device=cuda_sm90).manual_seed(1)
    qkv = torch.randn((2, 200, 12, 64), generator=gen, device=cuda_sm90)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out, attention_ref(q, k, v), atol=1e-5, rtol=1e-5)


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
