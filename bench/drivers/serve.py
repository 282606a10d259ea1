"""The ``serve`` driver: a closed loop with one client. Each request batch is
B prompts of P token ids drawn from the seed; ``repro_torch.launch.serve.serve``
prefills it and decodes N tokens greedily through the ``ServeStep`` that
set-up captured; the next batch is sent when the last token is back.

Set-up builds the model holding the benchmark's weights and the step, and
serves two warm-up batches of their own prompts: the first captures the
decode step's CUDA graph, the second copies its prefill's caches into the
graph's, as every request of the window does. A request's time runs from
its batch's send to its last token; the B requests of a batch finish
together. After the window the program is freed and a sample of the
window's batches, drawn from the seed, is checked: the reference runs once
over each prompt with its served tokens fed back, and the widest gap by
which a served token's logit lies below the reference's best is compared.
A traced run profiles ``traced_batches`` more batches after the window
(``bench.trace``), so that the window's timing carries no profiler; the
benchmark's spans name the calls into the program's layers: the request,
its prefill, the step's load of the prefill's caches, and the decode.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import random
import statistics
import sys
import time
from typing import List, Optional, Tuple

import torch

from bench import port
from bench import trace as tr
from bench.reference import common as ref
from bench.weights import family, make_weights, sub_seed
from bench.yardstick import compare

# faults a run can plant underneath the timed path (tests and control readings)
FAULTS = ("token", "unchanged")
ALTERED_STEP = 2          # the decode step whose token the "token" fault alters


def prompt_at(cfg: dict, mix: dict, seed: int, i: int, device) -> torch.Tensor:
    """Batch i's prompts [B, P] (warm-up batches take negative i)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "prompt", i))
    return torch.randint(0, cfg["vocab_size"], (mix["batch"], mix["prompt_len"]), generator=gen,
                         device=device)


@contextlib.contextmanager
def _planted(model, step, fault: Optional[str]):
    """``token``: one decode step's token altered where the step makes it;
    ``unchanged``: the decode steps leave the caches as they were."""
    if fault is None:
        yield
        return
    if fault == "token":
        real, count = type(step).__call__, [0]

        def altered(self, caches, inp, pos):
            caches, token = real(self, caches, inp, pos)
            count[0] += 1
            if count[0] == ALTERED_STEP:
                token = (token + 1) % model.cfg.vocab_size
            return caches, token
        type(step).__call__ = altered
        try:
            yield
        finally:
            type(step).__call__ = real
        return
    real_decode = model.decode_step

    def stale(caches, inp, pos):
        copy = [{k: t.clone() for k, t in c.items()} for c in caches]
        return caches, real_decode(copy, inp, pos)[1]
    model.decode_step = stale
    try:
        yield
    finally:
        del model.decode_step


def _spanned(fn, name: str):
    """``fn`` inside the benchmark's span ``name``."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with tr.span(name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def _decode_spanned():
    """The program's greedy decode, as ``serve`` calls it, inside a span."""
    mod = importlib.import_module("repro_torch.launch.serve")
    real = mod.greedy_decode
    mod.greedy_decode = _spanned(real, "decode")
    try:
        yield
    finally:
        mod.greedy_decode = real


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, fault: Optional[str] = None):
        from repro_torch.config.base import ParallelConfig
        from repro_torch.launch.serve import serve
        from repro_torch.serve.decode import make_serve_step
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")
        self.cfg, self.mix, self.seed, self.device, self.fault = cfg, mix, seed, device, fault
        self.model = port.build(cfg, make_weights(cfg, seed, device), device)
        self.step, _, _ = make_serve_step(self.model, ParallelConfig(data=1, model=1), None,
                                          mix["batch"], mix["prompt_len"] + mix["max_new"])
        self.model.prefill = _spanned(self.model.prefill, "prefill")
        self.step.load = _spanned(self.step.load, "load")
        self._serve = serve
        for i in (-1, -2):
            self.request(prompt_at(cfg, mix, seed, i, device))

    def request(self, prompt: torch.Tensor):
        with tr.span("request"), _decode_spanned(), _planted(self.model, self.step, self.fault):
            return self._serve(self.model, prompt, self.mix["max_new"], step=self.step)

    def free(self) -> None:
        self.model = self.step = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def fed(cfg: dict, mix: dict, seed: int, i: int, tokens: torch.Tensor, device) -> torch.Tensor:
    """What the reference reads for batch i: its prompts with the served
    tokens fed back (all but the last)."""
    return torch.cat([prompt_at(cfg, mix, seed, i, device), tokens.to(device)[:, :-1]], dim=1)


def check(cfg: dict, mix: dict, seed: int, checked: List[Tuple[int, torch.Tensor]],
          device) -> dict:
    """The reference's logits over the checked batches' prompts and served
    tokens (``checked``: each batch's index and tokens): the widest and the
    mean gap of a served token below the reference's best."""
    ref.no_tf32()
    params = make_weights(cfg, seed, device)
    block, p = family(cfg).block, mix["prompt_len"]
    got = []
    for i, tokens in checked:
        logits = ref.served_logits(block, cfg, params, fed(cfg, mix, seed, i, tokens, device), p)
        got.append(compare.logit_gaps(logits, tokens.to(device)).flatten())
        del logits
    g = torch.cat(got)
    return {"logit_gap": float(g.max()), "mean_logit_gap": float(g.mean())}


def sample(seed: int, n: int, k: int) -> List[int]:
    """k of the window's n batches, drawn from the seed (all when n <= k)."""
    return sorted(random.Random(sub_seed(seed, "sample")).sample(range(n), min(k, n)))


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool, device,
        fault: Optional[str] = None) -> dict:
    t_build = time.perf_counter()
    prog = Program(cfg, mix, seed, device, fault)
    print(f"setup: program built and warmed in {time.perf_counter() - t_build:.2f} s",
          file=sys.stderr)
    b, n = mix["batch"], mix["max_new"]
    requests_ms, prefill_ms, served = [], [], []
    t0 = time.perf_counter()
    while True:
        prompt = prompt_at(cfg, mix, seed, len(served), device)
        sent = time.perf_counter()
        res = prog.request(prompt)
        t1 = time.perf_counter()
        requests_ms += [(t1 - sent) * 1e3] * b
        prefill_ms.append(res.prefill_ms)
        served.append(res.tokens)
        if t1 - t0 >= seconds:
            break
    batch_ms = requests_ms[::b]
    print(f"window: {len(served)} batches in {t1 - t0:.3f} s, batch ms min {min(batch_ms):.1f} "
          f"median {statistics.median(batch_ms):.1f} max {max(batch_ms):.1f}", file=sys.stderr)
    with tr.traced(traced) as holder:
        with tr.span("window"):
            for i in range(mix["traced_batches"] if traced else 0):
                with tr.span("prompt"):
                    prompt = prompt_at(cfg, mix, seed, len(served) + i, device)
                prog.request(prompt)
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    prog.free()
    checked = [(i, served[i]) for i in sample(seed, len(served), mix["checked_batches"])]
    t_ref = time.perf_counter()
    gaps = check(cfg, mix, seed, checked, device)
    print(f"reference: {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    return {"kind": "serve", "window_start": t0, "window_s": t1 - t0,
            "attempted": len(requests_ms), "failed": 0, "batches": len(served),
            "tokens": len(served) * b * n, "requests_ms": requests_ms, "prefill_ms": prefill_ms,
            "memory_peak_bytes": peak, "trace": holder["trace"], "gaps": gaps, "checked": checked}
