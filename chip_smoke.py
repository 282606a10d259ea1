#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA Hopper GPU: build, check, serve.

    python3 chip_smoke.py

Run from a checkout of the repository; it puts ``src`` on ``sys.path`` itself
and builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels`` at first use. Phases, each of which fails the run:

1. card: ``nvidia-smi`` name and power limit; requires compute capability 9.0;
2. build: every kernel source, one nvcc each, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, f32
   and bf16. Flash attention at the serving shape, a GQA shape and ragged S,
   with and without softcap; then kernel, plain version, library call and
   bound timed at S=512 and S=4096. The SSD scan (y and final state) against
   the step-by-step oracle at the mamba2 serving shape, ragged S=1000, two
   groups, chunk 64 and the smoke shape; then kernel, plain version and bound
   timed at the serving shape;
4. serve qwen1.5-0.5b at full width, bf16, random weights from a seed, through
   ``repro_torch.launch.serve`` (its default workload: batch 4, prompt 512, 32
   new tokens); the flash kernel's launch count over that run must be one per
   attention layer, and the card's prefill logits must agree with the same
   weights' f32 prefill on the CPU (plain path) at B=1, S=128. As a control,
   the same check is read with faults planted in place of the kernel (P
   rounded to bf16; causal mask dropped), and the dropped mask must fail it;
5. serve mamba2-370m the same way (its default workload: batch 4, prompt
   2048, 32 new tokens): one SSD-scan launch per SSD layer (48) per prefill,
   and the card-vs-CPU check at B=1, S=300 (two chunks of 128 and a ragged
   third), on the logits and on the first layer's final SSD state, with the
   controls "state not carried across chunks", which must fail it, and "xdt
   and C B^T L rounded to bf16" (the JAX model path's rounding), which is
   read.

Each serving path runs with every kernel's launch count set to 0 just before
it and read just after. The last three lines are the card's ``name,
power.limit``, the kernels' JSON record, and ``{"ok": true, "device": {...}}``.
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

QWEN, MAMBA = "qwen1.5-0.5b", "mamba2-370m"
# launch.serve's default workload of each arch: (batch, prompt_len, max_new)
WORKLOADS = {QWEN: (4, 512, 32), MAMBA: (4, 2048, 32)}
# (num_layers, d_model, vocab_size) at the published widths
FULL_WIDTH = {QWEN: (24, 1024, 151936), MAMBA: (48, 1024, 50280)}
PEAK_FLOPS_BF16 = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# (atol, rtol) of flash attention against the plain version computed in f32
# on the same input values: f32 sums in another order; bf16 adds one output
# rounding (2^-9 relative) to that.
KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}
# SSD scan, max abs error / max |reference| against the step-by-step oracle
# in f32 on the same input values: y in f32 as tests/test_kernels.py holds
# the Pallas kernel (1e-4); y in bf16 adds one output rounding (2^-9 of |y|);
# the final state is f32 either way.
SSD_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
STATE_TOL = 1e-4
# (b, s, h, p, g, n, chunk) of the SSD scan at the mamba2-370m serving shape
SSD_SERVING = (4, 2048, 32, 64, 1, 128, 128)
# Card (bf16 activations, kernels) vs CPU (f32, plain path) prefill of the
# same weights (see PERF.md), each reading relative to the largest value of
# its reference: bf16 rounds the residual stream at every layer.
# qwen, the last position's logits: sound runs read 1.6e-2 to 1.7e-2; a
# dropped causal mask must read above the limit.
# mamba2, the logits and the first layer's final SSD state: the SSD part of a
# random-weight block is small beside its D * x skip, so the last position's
# logits barely see a state that is not carried across chunks, while the
# first layer's state, where bf16 has rounded least, does. The control
# "state not carried" must read above one of the limits.
# Phase 3 is the gate for each kernel's precision.
CARD_VS_CPU_TOL = {QWEN: {"logits": 3e-2},
                   MAMBA: {"logits": 1e-1, "layer-0 state": 5e-2}}
REF_LEN = {QWEN: 128, MAMBA: 300}   # prompt of the card-vs-CPU check, B=1


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


def bound(flops: float, nbytes: float):
    """(least time in ms, what bounds it): operations at the bf16 peak or bytes
    at the memory rate, whichever takes longer."""
    t_ops, t_bytes = flops / PEAK_FLOPS_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound_ms(b: int, s: int, h: int, d: int, itemsize: int):
    """Least time for causal attention on these inputs: its operations (QK^T and
    P.V over the S(S+1)/2 causal pairs) and its bytes (q, k, v read once, o
    written once)."""
    return bound(4.0 * b * h * d * (s * (s + 1) / 2), 4.0 * b * s * h * d * itemsize)


def ssd_bound_ms(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
                 itemsize: int):
    """Least time for the SSD scan on these inputs: its operations (per head
    and chunk, C B^T and its product with xdt, 2L^2(n+p), and C.state and
    the state update, 4Lnp) and its bytes (x, B, C read once in their dtype,
    dt and A in f32; y written once in x's dtype, the final state in f32)."""
    nc = -(-s // chunk)
    flops = b * h * nc * (2.0 * chunk ** 2 * (n + p) + 4.0 * chunk * n * p)
    nbytes = (2 * b * s * h * p * itemsize + 2 * b * s * g * n * itemsize
              + 4 * (b * s * h + h) + 4 * b * h * n * p)
    return bound(flops, nbytes)


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    flash_attention_fwd.launches = 0
    ssd_scan_fwd.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    return {"flash_attention": flash_attention_fwd.launches,
            "ssd_scan": ssd_scan_fwd.launches}


def phase_flash(torch, card: str) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import attention_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch, prompt_len, _ = WORKLOADS[QWEN]

    def inputs(b, s, hq, hk, d, dtype):
        return tuple(torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
                     for h in (hq, hk, hk))

    cases = [  # name, B, S, Hq, Hk, D, dtype, softcap
        ("serving shape", batch, prompt_len, 16, 16, 64, "bfloat16", 0.0),
        ("serving shape", batch, prompt_len, 16, 16, 64, "bfloat16", 20.0),
        ("serving shape", batch, prompt_len, 16, 16, 64, "float32", 0.0),
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
    for s in (prompt_len, 4096):
        b, h, d = batch, 16, 64
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


def phase_ssd(torch, card: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, s, h, p, g, n, dtype):
        """x, B, C in ``dtype``; dt and A in f32, as the model gives them."""
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = randn(b, s, h, p).to(dtype)
        dt = torch.nn.functional.softplus(randn(b, s, h))
        A = -torch.exp(randn(h) * 0.5)
        B = (randn(b, s, g, n) * 0.3).to(dtype)
        C = (randn(b, s, g, n) * 0.3).to(dtype)
        return x, dt, A, B, C

    def rel(out, ref):
        return float((out.float() - ref).abs().max()) / (float(ref.abs().max()) + 1e-6)

    cases = [  # name, (b, s, h, p, g, n, chunk)
        ("serving shape", SSD_SERVING),
        ("ragged S=1000", (2, 1000, 32, 64, 1, 128, 128)),
        ("groups g=2 h=8", (2, 512, 8, 64, 2, 128, 128)),
        ("chunk L=64", (2, 1000, 8, 64, 1, 128, 64)),
        ("smoke shape", (2, 300, 4, 32, 1, 16, 32)),
    ]
    checks = []
    for name, (b, s, h, p, g, n, chunk) in cases:
        for dtype in ("float32", "bfloat16"):
            x, dt, A, B, C = inputs(b, s, h, p, g, n, getattr(torch, dtype))
            y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
            torch.cuda.synchronize()
            y_ref, state_ref = ssd_ref(x.float(), dt, A, B.float(), C.float())
            err_y, err_state = rel(y, y_ref), rel(state, state_ref)
            abs_err = float((y.float() - y_ref).abs().max())
            ok = (err_y <= SSD_TOL[dtype] and err_state <= STATE_TOL and y.dtype == x.dtype
                  and tuple(state.shape) == (b, h, n, p))
            print(f"  ssd_scan {name:15s} b={b} s={s} h={h} p={p} g={g} n={n} L={chunk} "
                  f"{dtype:8s}: y max_abs_err={abs_err:.3e} rel={err_y:.3e} (tolerance "
                  f"{SSD_TOL[dtype]:g}), state rel={err_state:.3e} (tolerance "
                  f"{STATE_TOL:g}) {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"ssd_scan disagrees with ssd_ref at {name} {dtype}")
            checks.append({"case": f"{name} {dtype}", "max_abs_err": abs_err,
                           "rel_err": err_y, "state_rel_err": err_state,
                           "rel_tol": SSD_TOL[dtype], "state_rel_tol": STATE_TOL})

    b, s, h, p, g, n, chunk = SSD_SERVING
    x, dt, A, B, C = inputs(b, s, h, p, g, n, torch.bfloat16)
    ms = time_ms(torch, lambda: ssd_scan_fwd(x, dt, A, B, C, chunk=chunk), 20)
    plain_ms = time_ms(torch, lambda: ops.ssd_scan_plain(x, dt, A, B, C, chunk=chunk), 5)
    bound_ms, bound_by = ssd_bound_ms(b, s, h, p, g, n, chunk, 2)
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"  ssd_scan b={b} s={s} h={h} p={p} n={n} L={chunk} bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms ({bound_by}) "
          f"[{card}]", flush=True)
    return {"checks": checks, "timing": timing}


def phase_serve(torch, card: str, arch: str, planted: dict, must_fail: str) -> dict:
    """Serves ``arch`` at full width through launch.serve and checks it.

    ``planted`` maps a fault's name to (module, attribute, replacement): the
    card-vs-CPU logits check is read again with each in place of the kernel's
    op, and the reading of ``must_fail`` must exceed the limit."""
    from repro_torch.config.base import ATTN, SSD
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model

    batch, prompt_len, max_new = WORKLOADS[arch]
    check(tuple(launch_serve.WORKLOADS[arch]) == WORKLOADS[arch],
          f"chip_smoke's {arch} workload is not launch.serve's default workload")
    model = launch_serve.build(arch, device="cuda")
    cfg = model.cfg
    check((cfg.num_layers, cfg.d_model, cfg.vocab_size) == FULL_WIDTH[arch],
          f"{arch} is not at full width: {cfg}")
    mixers = [mixer for mixer, _ in cfg.layer_blocks()]
    expected = {"flash_attention": mixers.count(ATTN), "ssd_scan": mixers.count(SSD)}
    prompt = launch_serve.random_prompt(model, batch, prompt_len)
    launch_serve.serve(model, prompt, 2)     # warm-up: cuBLAS handles, allocator

    reset_counts()
    res = launch_serve.serve(model, prompt, max_new)
    launches = read_counts()
    print(f"  serve {arch} B={batch} prompt={prompt_len} new={max_new}: prefill "
          f"{res.prefill_ms:.2f} ms, decode {res.decode_tok_s:.1f} tok/s "
          f"({res.decode_tokens} tokens in {res.decode_ms:.2f} ms), launches {launches} "
          f"[{card}]", flush=True)
    check(launches == expected, f"kernel launches {launches} in one prefill, expected "
          f"{expected} (one per layer of the kernel's mixer)")
    check(tuple(res.tokens.shape) == (batch, max_new), f"tokens {tuple(res.tokens.shape)}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()), "token out of range")
    for name, t in (("prefill", res.prefill_logits), ("last decode", res.logits)):
        check(tuple(t.shape) == (batch, cfg.vocab_size) and t.dtype == torch.float32,
              f"{name} logits {tuple(t.shape)} {t.dtype}")
        check(bool(torch.isfinite(t).all()), f"{name} logits are not finite")

    # The same weights' prefill in f32 on the CPU through the plain path.
    ref_len, limits = REF_LEN[arch], CARD_VS_CPU_TOL[arch]
    small = launch_serve.random_prompt(model, 1, ref_len, seed=2)
    reset_counts()
    card_out = model.prefill(small, max_len=ref_len)
    check(read_counts() == expected, "reference prefill missed the kernels")
    cpu_cfg = dataclasses.replace(cfg, act_dtype="float32", param_dtype="float32")
    cpu_model = build_model(cpu_cfg, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    cpu_caches, cpu_logits = cpu_model.prefill(small.cpu(), max_len=ref_len)
    del cpu_model
    refs = {"logits": cpu_logits}
    if "layer-0 state" in limits:
        refs["layer-0 state"] = cpu_caches[0]["ssm"]

    def readings_of(out) -> dict:
        caches, logits = out
        got = {"logits": logits, "layer-0 state": caches[0].get("ssm")}
        return {k: float((got[k].cpu() - ref).abs().max()) / float(ref.abs().max())
                for k, ref in refs.items()}

    sound = readings_of(card_out)
    same_top = bool((card_out[1].argmax(-1).cpu() == cpu_logits.argmax(-1)).all())
    print(f"  card bf16 vs CPU f32 prefill (B=1, S={ref_len}), max_abs_err / max|ref|: "
          + ", ".join(f"{k} {v:.3e} (tolerance {limits[k]:g})" for k, v in sound.items())
          + f"; same argmax={same_top}", flush=True)
    check(all(v <= limits[k] for k, v in sound.items()),
          f"{arch}: card prefill disagrees with the CPU f32 path")

    # Controls: the same readings with a fault planted in place of the kernel.
    controls = {}
    for fault, (module, attr, fn) in planted.items():
        kernel_path = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            controls[fault] = readings_of(model.prefill(small, max_len=ref_len))
        finally:
            setattr(module, attr, kernel_path)
        print(f"  control, {fault}: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                                   controls[fault].items()), flush=True)
    check(any(v > limits[k] for k, v in controls[must_fail].items()),
          f"the card-vs-CPU check does not catch: {must_fail}")
    return {"arch": arch, "batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            "launches": launches, "prefill_ms": res.prefill_ms,
            "decode_tok_s": res.decode_tok_s, "card_vs_cpu": sound,
            "card_vs_cpu_tol": limits, "planted": controls}


def qwen_faults(torch) -> dict:
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import transformer

    def mask_dropped(q, k, v):   # qwen: Hq = Hk
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.float()).to(q.dtype)

    def p_bf16(q, k, v):
        return attention_ref(q, k, v, p_dtype=torch.bfloat16)

    return {"P rounded to bf16": (transformer, "flash_attention", p_bf16),
            "causal mask dropped": (transformer, "flash_attention", mask_dropped)}


def mamba_faults(torch) -> dict:
    from repro_torch.kernels.ops import ssd_scan_plain
    from repro_torch.models import ssm

    def state_not_carried(x, dt, A, B, C, *, chunk):
        """Each chunk scanned from a zero state: y_off dropped."""
        s = x.shape[1]
        step = min(chunk, s)
        parts = [ssd_scan_plain(x[:, i:i + step], dt[:, i:i + step], A, B[:, i:i + step],
                                C[:, i:i + step], chunk=step) for i in range(0, s, step)]
        return torch.cat([y for y, _ in parts], dim=1), parts[-1][1]

    def model_path_rounding(x, dt, A, B, C, *, chunk):
        """ssd_chunked in x's dtype, as the JAX model path runs it."""
        return ssm.ssd_chunked(x, dt, A, B, C, chunk=chunk)

    return {"state not carried across chunks": (ssm, "ssd_scan", state_not_carried),
            "xdt and C B^T L rounded to bf16": (ssm, "ssd_scan", model_path_rounding)}


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
    print(f"[1/5] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}, compute capability {cap[0]}.{cap[1]}", flush=True)
    check(cap == (9, 0), f"needs compute capability 9.0 (sm_90a), found {cap}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(build.sources())
    print(f"[2/5] build: {len(logs)} of {len(build.sources())} kernel sources compiled "
          f"in {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    t0 = time.perf_counter()
    print("[3/5] kernels against their plain versions", flush=True)
    flash = phase_flash(torch, card)
    ssd = phase_ssd(torch, card)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)

    served = {}
    for i, (arch, faults, must_fail) in enumerate((
            (QWEN, qwen_faults(torch), "causal mask dropped"),
            (MAMBA, mamba_faults(torch), "state not carried across chunks")), start=4):
        t0 = time.perf_counter()
        print(f"[{i}/5] serve {arch} at full width", flush=True)
        served[arch] = phase_serve(torch, card, arch, faults, must_fail)
        print(f"  ({time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    def worst(checks, prefix):
        return max(c["max_abs_err"] for c in checks if c["case"].startswith(prefix))

    qb, qs, _ = WORKLOADS[QWEN]
    flash_main = flash["timings"][qs]
    b, s, h, p, g, n, chunk = SSD_SERVING
    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": served[QWEN]["launches"]["flash_attention"],
        "max_abs_err": worst(flash["checks"], "serving shape bfloat16"),
        "ms": flash_main["ms"], "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"], "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
        "shape": f"B={qb} S={qs} H=16 D=64 bf16",
        "s4096": flash["timings"][4096],
        "checks": flash["checks"],
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:71",
        "launches": served[MAMBA]["launches"]["ssd_scan"],
        "max_abs_err": worst(ssd["checks"], "serving shape bfloat16"),
        **ssd["timing"],
        "shape": f"b={b} s={s} h={h} p={p} g={g} n={n} L={chunk} bf16",
        "checks": ssd["checks"],
    }]}
    print(json.dumps({"serve": served}))
    print(smi_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
