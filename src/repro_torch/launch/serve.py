"""Serving entry point: prefill a batch of random prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch mamba2-370m] \
        [--batch 4] [--prompt-len 2048] [--max-new 32] [--device cpu] [--smoke]

Each arch has a default workload (``WORKLOADS``): qwen1.5-0.5b batch 4,
prompt 512, 32 new tokens; mamba2-370m batch 4, prompt 2048 (16 chunks of
128 carried in order, the long-prompt regime an SSM is chosen for), 32 new
tokens; recurrentgemma-2b batch 4, prompt 4096 (two windows of its local
attention, so the band is real, and the decode steps wrap the ring), 32 new
tokens; internlm2-1.8b, internvl2-2b and granite-moe-1b-a400m batch 4,
prompt 2048, 32 new tokens; musicgen-large batch 4, 1500 frames (30 s of
EnCodec's 50 Hz tokens), 32 new; phi3.5-moe-42b-a6.6b batch 4, prompt 2048,
32 new, at 8 of its 32 layers; deepseek-67b batch 1, prompt 4096, 16 new,
at 8 of 95 layers; nemotron-4-340b batch 1, prompt 4096, 16 new, at 2 of 96
layers. Those three are cut in depth only, to fit one 80 GB card in bf16
(83.7, 134.9 and 682.1 GB at full depth); widths stay the published ones,
and the depth served is printed with the result.

Weights are random, drawn from seed 0; prompts from seed 1: token ids, or
for a model of embedding inputs (musicgen-large, internvl2-2b: a stubbed
EnCodec or ViT frontend) embeddings [B, S, d_model] bf16, N(0, 1); such a
model is fed the prompt's last embedding at every decode step, and its
argmax tokens are the output, as ``repro.launch.serve`` does. Decode runs
through ``serve.decode.make_serve_step``'s step: on the card one CUDA graph
of the whole step, captured at the first request of a (batch, cache length)
and replayed per token, later requests copying their prefill's caches into
the graph's; on the CPU the same step eagerly. The request's time is
printed: prefill, the capture (or cache copy), decode, and their sum. Runs
on the GPU unless ``--device cpu`` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.config.base import ParallelConfig
from repro_torch.config.registry import get_model_config, list_archs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.serve.decode import ServeStep, greedy_decode, make_serve_step


class Workload(NamedTuple):
    batch: int
    prompt_len: int
    max_new: int
    layers: Optional[int] = None   # a depth cut to fit the card; None: the config's


# Each arch's default workload, which launch.profile_serve profiles as it is.
WORKLOADS = {
    "qwen1.5-0.5b": Workload(batch=4, prompt_len=512, max_new=32),
    "mamba2-370m": Workload(batch=4, prompt_len=2048, max_new=32),
    "recurrentgemma-2b": Workload(batch=4, prompt_len=4096, max_new=32),
    "internlm2-1.8b": Workload(batch=4, prompt_len=2048, max_new=32),
    "internvl2-2b": Workload(batch=4, prompt_len=2048, max_new=32),
    "granite-moe-1b-a400m": Workload(batch=4, prompt_len=2048, max_new=32),
    "musicgen-large": Workload(batch=4, prompt_len=1500, max_new=32),
    "phi3.5-moe-42b-a6.6b": Workload(batch=4, prompt_len=2048, max_new=32, layers=8),
    "deepseek-67b": Workload(batch=1, prompt_len=4096, max_new=16, layers=8),
    "nemotron-4-340b": Workload(batch=1, prompt_len=4096, max_new=16, layers=2),
}
ARCH = "qwen1.5-0.5b"


@dataclass
class ServeResult:
    tokens: torch.Tensor          # [B, max_new]
    prefill_logits: torch.Tensor  # [B, V] f32, last prompt position
    logits: torch.Tensor          # [B, V] f32, the last step's
    prefill_ms: float
    decode_ms: float
    decode_tokens: int            # tokens made by the decode steps (B * (max_new - 1))
    # on the card, between prefill and decode: the step's graph capture (the
    # first request of its shape: ``captured``) or the copy of the prefill's
    # caches into the graph's
    load_ms: float = 0.0
    captured: bool = False
    prefill_caches: Optional[list] = None   # a copy of the prefill's caches, if asked for

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / (self.decode_ms / 1e3) if self.decode_ms else 0.0

    @property
    def request_ms(self) -> float:
        """The whole request: prefill, capture or cache copy, decode."""
        return self.prefill_ms + self.load_ms + self.decode_ms


def build(arch: str, *, smoke: bool = False, device: DeviceLike = None,
          seed: int = 0, layers: Optional[int] = None) -> Model:
    """The arch's model on ``device`` with random weights from ``seed``, at
    ``layers`` of depth (None: the config's)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = get_model_config(arch, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return build_model(cfg, device=dev, generator=gen)


def random_prompt(model: Model, batch: int, prompt_len: int, *, seed: int = 1
                  ) -> torch.Tensor:
    """On the model's device: token ids [batch, prompt_len], uniform over the
    vocab, or for a model of embedding inputs embeddings [batch, prompt_len,
    d_model] bf16, N(0, 1)."""
    dev, cfg = model.device, model.cfg
    gen = torch.Generator(device=dev).manual_seed(seed)
    if not cfg.embed_inputs:
        return torch.randn((batch, prompt_len, cfg.d_model), generator=gen, device=dev,
                           dtype=torch.bfloat16)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model: Model, prompt: torch.Tensor, max_new: int, *,
          step: Optional[ServeStep] = None, keep_prefill: bool = False) -> ServeResult:
    """Prefill, then greedy decode through ``step`` (default: a new one from
    ``make_serve_step``; on the card its CUDA graph, captured at its first
    request of this shape, else loaded with the prefill's caches, timed
    apart); each phase timed on the host clock after the device has
    finished. ``keep_prefill`` keeps a copy of the prefill's caches in the
    result (for a second decode from them)."""
    dev = prompt.device
    b, s = prompt.shape[:2]
    last = None if model.cfg.embed_inputs else prompt[:, -1:]
    if step is None:
        step, _, _ = make_serve_step(model, ParallelConfig(data=1, model=1), None, b,
                                     s + max_new)
    captures = step.captures
    _sync(dev)
    t0 = time.perf_counter()
    caches, prefill_logits = model.prefill(prompt, max_len=s + max_new)
    token = torch.argmax(prefill_logits, dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    kept = [{k: t.clone() for k, t in c.items()} for c in caches] if keep_prefill else None
    _sync(dev)
    t1b = time.perf_counter()
    if dev.type == "cuda" and max_new > 1:
        caches = step.load(caches, token if last is None else last)
    _sync(dev)
    t2 = time.perf_counter()
    rest, logits = greedy_decode(model, caches, token, s, max_new - 1, last, step=step)
    _sync(dev)
    t3 = time.perf_counter()
    return ServeResult(
        tokens=torch.cat([token[:, None], rest], dim=1),
        prefill_logits=prefill_logits,
        logits=prefill_logits if logits is None else logits,
        prefill_ms=(t1 - t0) * 1e3, decode_ms=(t3 - t2) * 1e3,
        decode_tokens=b * (max_new - 1), load_ms=(t2 - t1b) * 1e3,
        captured=step.captures > captures, prefill_caches=kept)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=ARCH, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, help="default: the arch's workload")
    ap.add_argument("--prompt-len", type=int, help="default: the arch's workload")
    ap.add_argument("--max-new", type=int, help="default: the arch's workload")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises when no GPU is visible")
    args = ap.parse_args(argv)
    work = WORKLOADS[args.arch]
    for key in ("batch", "prompt_len", "max_new"):
        if getattr(args, key) is None:
            setattr(args, key, getattr(work, key))
    layers = None if args.smoke else work.layers   # a depth cut is for the published widths

    model = build(args.arch, smoke=args.smoke, device=args.device, layers=layers)
    prompt = random_prompt(model, args.batch, args.prompt_len)
    res = serve(model, prompt, args.max_new)
    dev = prompt.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    cfg = get_model_config(args.arch, smoke=args.smoke)
    depth = (f", {model.cfg.num_layers} of {cfg.num_layers} layers"
             if model.cfg.num_layers != cfg.num_layers else "")
    load = f"graph capture {res.load_ms:.2f} ms" if dev.type == "cuda" else "eager steps"
    print(f"{args.arch}{' (smoke)' if args.smoke else ''}{depth} on {name}: "
          f"prefill {args.batch}x{args.prompt_len} in {res.prefill_ms:.2f} ms, {load}, "
          f"{res.decode_tokens} decode tokens in {res.decode_ms:.2f} ms "
          f"({res.decode_tok_s:.1f} tok/s); request {res.request_ms:.2f} ms")
    print("sample:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
