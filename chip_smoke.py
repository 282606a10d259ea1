#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA Hopper GPU: build, check, serve.

    python3 chip_smoke.py

Run from a checkout of the repository; it puts ``src`` on ``sys.path`` itself
and builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels`` at first use. Phases, each of which fails the run:

1. card: ``nvidia-smi`` name and power limit; requires compute capability 9.0;
2. build: every kernel source, one nvcc each, all started together;
3. kernels: each kernel against its plain PyTorch version on the card at the
   serving shape, a GQA shape and ragged S, f32 and bf16, with and without
   softcap; then kernel, plain version, library call and bound timed at S=512
   and S=4096;
4. serve: qwen1.5-0.5b at full width, bf16, random weights from a seed, through
   ``repro_torch.launch.serve`` (its default workload: batch 4, prompt 512, 32
   new tokens); the kernel's launch count over that run must be one per
   attention layer, and the card's prefill logits must agree with the same
   weights' f32 prefill on the CPU (plain path) at B=1, S=128. As a control,
   the same check is read with faults planted in place of the kernel (P
   rounded to bf16; causal mask dropped), and the dropped mask must fail it.

The last three lines are the card's ``name, power.limit``, the kernels'
JSON record, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "qwen1.5-0.5b"
BATCH, PROMPT_LEN, MAX_NEW = 4, 512, 32
PEAK_FLOPS_BF16 = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# (atol, rtol) of the kernel against the plain version computed in f32 on
# the same input values: f32 sums in another order; bf16 adds one output
# rounding (2^-9 relative) to that.
KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}
# Card (bf16 activations, kernel) vs CPU (f32, plain path) prefill logits of
# the same weights, relative to the largest logit: bf16 rounds the residual
# stream at every one of the 24 layers. Sound runs read 1.6e-2 to 1.7e-2
# (see PERF.md); a dropped causal mask, planted in place of the kernel, must
# read above the limit. Phase 3 is the gate for the kernel's precision.
LOGITS_REL_TOL = 3e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b: int, s: int, h: int, d: int, itemsize: int):
    """Least time for causal attention on these inputs: the larger of its
    operations (QK^T and P.V over the S(S+1)/2 causal pairs) at the bf16 peak
    and its bytes (q, k, v read once, o written once) at the memory rate."""
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    nbytes = 4.0 * b * s * h * d * itemsize
    t_ops, t_bytes = flops / PEAK_FLOPS_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(torch, card: str) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import attention_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, s, hq, hk, d, dtype):
        return tuple(torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
                     for h in (hq, hk, hk))

    cases = [  # name, B, S, Hq, Hk, D, dtype, softcap
        ("serving shape", BATCH, PROMPT_LEN, 16, 16, 64, "bfloat16", 0.0),
        ("serving shape", BATCH, PROMPT_LEN, 16, 16, 64, "bfloat16", 20.0),
        ("serving shape", BATCH, PROMPT_LEN, 16, 16, 64, "float32", 0.0),
        ("gqa 8/2 d128", 2, 512, 8, 2, 128, "bfloat16", 0.0),
        ("gqa 8/2 d128", 2, 512, 8, 2, 128, "float32", 20.0),
        ("ragged S=1000", 2, 1000, 8, 2, 128, "bfloat16", 30.0),
        ("ragged S=1000", 2, 1000, 16, 16, 64, "float32", 0.0),
        ("ragged d256", 1, 300, 4, 2, 256, "bfloat16", 0.0),
        ("ragged d32", 2, 77, 6, 2, 32, "float32", 50.0),
    ]
    checks = []
    for name, b, s, hq, hk, d, dtype, softcap in cases:
        q, k, v = inputs(b, s, hq, hk, d, getattr(torch, dtype))
        out = ops.flash_attention(q, k, v, softcap=softcap)
        torch.cuda.synchronize()
        ref = attention_ref(q.float(), k.float(), v.float(), softcap=softcap)
        atol, rtol = KERNEL_TOL[dtype]
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        ok = bool((diff <= atol + rtol * ref.abs()).all()) and out.dtype == q.dtype
        print(f"  flash_attention {name:14s} B={b} S={s} Hq={hq} Hk={hk} D={d} "
              f"{dtype:8s} softcap={softcap:4.1f}: max_abs_err={err:.3e} "
              f"(tolerance |err| <= {atol:g} + {rtol:g}|ref|) {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"flash_attention disagrees with attention_ref at {name} {dtype}")
        checks.append({"case": f"{name} {dtype} softcap={softcap}", "max_abs_err": err,
                       "atol": atol, "rtol": rtol})

    timings = {}
    for s in (PROMPT_LEN, 4096):
        b, h, d = BATCH, 16, 64
        q, k, v = inputs(b, s, h, h, d, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D] views
        iters = 50 if s <= 512 else 10
        ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v), iters)
        plain_ms = time_ms(torch, lambda: attention_ref(q, k, v), max(iters // 5, 2))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters)
        bound_ms, bound_by = attention_bound_ms(b, s, h, d, 2)
        timings[s] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"  flash_attention B={b} S={s} H={h} D={d} bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}) [{card}]", flush=True)
    return {"checks": checks, "timings": timings}


def phase_serve(torch, card: str) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model, transformer

    check((ARCH, BATCH, PROMPT_LEN, MAX_NEW) == (launch_serve.ARCH, launch_serve.BATCH,
                                                 launch_serve.PROMPT_LEN, launch_serve.MAX_NEW),
          "chip_smoke's workload is not launch.serve's default workload")
    model = launch_serve.build(ARCH, device="cuda")
    cfg = model.cfg
    n_attn = sum(1 for mixer, _ in cfg.layer_blocks() if mixer == "attn")
    check(cfg.d_model == 1024 and cfg.num_layers == 24 and cfg.vocab_size == 151936,
          f"{ARCH} is not at full width: {cfg}")
    prompt = launch_serve.random_prompt(model, BATCH, PROMPT_LEN)
    launch_serve.serve(model, prompt, 2)     # warm-up: cuBLAS handles, allocator

    flash_attention_fwd.launches = 0
    res = launch_serve.serve(model, prompt, MAX_NEW)
    launches = flash_attention_fwd.launches
    print(f"  serve {ARCH} B={BATCH} prompt={PROMPT_LEN} new={MAX_NEW}: prefill "
          f"{res.prefill_ms:.2f} ms, decode {res.decode_tok_s:.1f} tok/s "
          f"({res.decode_tokens} tokens in {res.decode_ms:.2f} ms), flash_attention "
          f"launches {launches} [{card}]", flush=True)
    check(launches == n_attn, f"flash_attention launched {launches} times in one "
          f"prefill, expected {n_attn} (one per attention layer)")
    check(tuple(res.tokens.shape) == (BATCH, MAX_NEW), f"tokens {tuple(res.tokens.shape)}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()), "token out of range")
    for name, t in (("prefill", res.prefill_logits), ("last decode", res.logits)):
        check(tuple(t.shape) == (BATCH, cfg.vocab_size) and t.dtype == torch.float32,
              f"{name} logits {tuple(t.shape)} {t.dtype}")
        check(bool(torch.isfinite(t).all()), f"{name} logits are not finite")

    # The same weights' prefill in f32 on the CPU through the plain path.
    small = launch_serve.random_prompt(model, 1, 128, seed=2)
    before = flash_attention_fwd.launches
    _, card_logits = model.prefill(small, max_len=128)
    check(flash_attention_fwd.launches - before == n_attn, "reference prefill missed the kernel")
    cpu_cfg = dataclasses.replace(cfg, act_dtype="float32", param_dtype="float32")
    cpu_model = build_model(cpu_cfg, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    _, cpu_logits = cpu_model.prefill(small.cpu(), max_len=128)
    scale = float(cpu_logits.abs().max())

    def rel_err(logits) -> float:
        return float((logits.cpu() - cpu_logits).abs().max()) / scale

    rel = rel_err(card_logits)
    same_top = bool((card_logits.argmax(-1).cpu() == cpu_logits.argmax(-1)).all())
    print(f"  card bf16 vs CPU f32 prefill logits (B=1, S=128): max_abs_err="
          f"{rel * scale:.4e}, max|ref|={scale:.4e}, rel={rel:.3e} (tolerance "
          f"{LOGITS_REL_TOL:g}), same argmax={same_top}", flush=True)
    check(rel <= LOGITS_REL_TOL, "card prefill logits disagree with the CPU f32 path")

    # Controls: the same reading with a fault planted in place of the kernel.
    def mask_dropped(q, k, v):   # qwen: Hq = Hk
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.float()).to(q.dtype)

    planted = {"P rounded to bf16": lambda q, k, v: attention_ref(q, k, v, p_dtype=torch.bfloat16),
               "causal mask dropped": mask_dropped}
    readings = {}
    kernel_path = transformer.flash_attention
    for fault, attn in planted.items():
        transformer.flash_attention = attn
        try:
            _, fault_logits = model.prefill(small, max_len=128)
        finally:
            transformer.flash_attention = kernel_path
        readings[fault] = rel_err(fault_logits)
        print(f"  control, {fault}: rel={readings[fault]:.3e}", flush=True)
    check(readings["causal mask dropped"] > LOGITS_REL_TOL,
          "the logits check does not catch a dropped causal mask")
    return {"launches": launches, "prefill_ms": res.prefill_ms,
            "decode_tok_s": res.decode_tok_s, "logits_rel_err": rel,
            "planted_rel_err": readings}


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = smi_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[1/4] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}, compute capability {cap[0]}.{cap[1]}", flush=True)
    check(cap == (9, 0), f"needs compute capability 9.0 (sm_90a), found {cap}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(build.sources())
    print(f"[2/4] build: {len(logs)} of {len(build.sources())} kernel sources compiled "
          f"in {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    t0 = time.perf_counter()
    print("[3/4] kernels against their plain versions", flush=True)
    kern = phase_kernels(torch, card)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    print(f"[4/4] serve {ARCH} at full width", flush=True)
    served = phase_serve(torch, card)
    print(f"  ({time.perf_counter() - t0:.1f} s; total {time.perf_counter() - t_start:.1f} s)",
          flush=True)

    main_path = kern["timings"][PROMPT_LEN]
    slice_err = max(c["max_abs_err"] for c in kern["checks"]
                    if c["case"].startswith("serving shape bfloat16"))
    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": served["launches"],
        "max_abs_err": slice_err, "max_err": slice_err,
        "ms": main_path["ms"], "kernel_ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"], "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"], "library_ms": main_path["library_ms"],
        "shape": f"B={BATCH} S={PROMPT_LEN} H=16 D=64 bf16",
        "s4096": kern["timings"][4096],
        "checks": kern["checks"],
    }]}
    print(json.dumps({"serve": {"arch": ARCH, "batch": BATCH, "prompt_len": PROMPT_LEN,
                                "max_new": MAX_NEW, **served}}))
    print(smi_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
