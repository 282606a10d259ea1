"""Serving entry point: prefill a batch of random prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch mamba2-370m] \
        [--batch 4] [--prompt-len 2048] [--max-new 32] [--device cpu] [--smoke]

Each arch has a default workload (``WORKLOADS``): qwen1.5-0.5b batch 4,
prompt 512, 32 new tokens; mamba2-370m batch 4, prompt 2048 (16 chunks of
128 carried in order, the long-prompt regime an SSM is chosen for), 32 new
tokens; recurrentgemma-2b batch 4, prompt 4096 (two windows of its local
attention, so the band is real, and the decode steps wrap the ring), 32 new
tokens. Runs on the GPU unless ``--device cpu`` is given; without a GPU it
raises. Weights are random, drawn from seed 0; prompts from seed 1.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.config.registry import get_model_config, ported_archs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.serve.decode import greedy_decode


class Workload(NamedTuple):
    batch: int
    prompt_len: int
    max_new: int


# Each arch's default workload, which launch.profile_serve profiles as it is.
WORKLOADS = {
    "qwen1.5-0.5b": Workload(batch=4, prompt_len=512, max_new=32),
    "mamba2-370m": Workload(batch=4, prompt_len=2048, max_new=32),
    "recurrentgemma-2b": Workload(batch=4, prompt_len=4096, max_new=32),
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

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / (self.decode_ms / 1e3) if self.decode_ms else 0.0


def build(arch: str, *, smoke: bool = False, device: DeviceLike = None,
          seed: int = 0) -> Model:
    """The arch's model on ``device`` with random weights from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return build_model(get_model_config(arch, smoke=smoke), device=dev, generator=gen)


def random_prompt(model: Model, batch: int, prompt_len: int, *, seed: int = 1
                  ) -> torch.Tensor:
    """Token ids [batch, prompt_len], uniform over the vocab, on the model's device."""
    dev = model.embed.tok.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, model.cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model: Model, prompt: torch.Tensor, max_new: int) -> ServeResult:
    """Prefill, then greedy decode; each phase timed on the host clock after
    the device has finished."""
    dev = prompt.device
    b, s = prompt.shape
    _sync(dev)
    t0 = time.perf_counter()
    caches, prefill_logits = model.prefill(prompt, max_len=s + max_new)
    token = torch.argmax(prefill_logits, dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    rest, logits = greedy_decode(model, caches, token, s, max_new - 1)
    _sync(dev)
    t2 = time.perf_counter()
    return ServeResult(
        tokens=torch.cat([token[:, None], rest], dim=1),
        prefill_logits=prefill_logits,
        logits=prefill_logits if logits is None else logits,
        prefill_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3,
        decode_tokens=b * (max_new - 1))


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=ARCH, choices=ported_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, help="default: the arch's workload")
    ap.add_argument("--prompt-len", type=int, help="default: the arch's workload")
    ap.add_argument("--max-new", type=int, help="default: the arch's workload")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises when no GPU is visible")
    args = ap.parse_args(argv)
    for key, default in WORKLOADS[args.arch]._asdict().items():
        if getattr(args, key) is None:
            setattr(args, key, default)

    model = build(args.arch, smoke=args.smoke, device=args.device)
    prompt = random_prompt(model, args.batch, args.prompt_len)
    res = serve(model, prompt, args.max_new)
    dev = prompt.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{args.arch}{' (smoke)' if args.smoke else ''} on {name}: "
          f"prefill {args.batch}x{args.prompt_len} in {res.prefill_ms:.2f} ms, "
          f"{res.decode_tokens} decode tokens in {res.decode_ms:.2f} ms "
          f"({res.decode_tok_s:.1f} tok/s)")
    print("sample:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
