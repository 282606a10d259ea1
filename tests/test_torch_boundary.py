"""The port's boundary: no JAX, nothing of the JAX package, no quiet CPU fallback."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(n for n in sys.modules if n.split(".")[0] in {forbidden!r})
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_import_statement_names_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|repro)(\.|\s|$)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert not hits


@pytest.mark.parametrize("entry,argv", [
    ("serve", ["--smoke", "--batch", "1", "--prompt-len", "8", "--max-new", "2"]),
    ("serve", ["--arch", "mamba2-370m", "--smoke"]),
    ("serve", ["--arch", "recurrentgemma-2b", "--smoke"]),
    ("profile_serve", []),
    ("profile_serve", ["--arch", "mamba2-370m"]),
    ("profile_serve", ["--arch", "recurrentgemma-2b"]),
    ("geo_training", ["--horizon-us", "100"]),
    ("profile_netsim", ["--schemes", "dcqcn"]),
    ("dryrun", ["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh", "single"]),
])
def test_entry_points_raise_without_gpu(entry, argv):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{entry}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)


def test_build_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    from repro_torch.config import get_model_config
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_model_config("qwen1.5-0.5b", smoke=True))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b"])
def test_serve_on_cpu_when_asked(arch):
    from repro_torch.launch import serve
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--max-new", "3"])
    assert res.tokens.shape == (2, 3)
    assert torch.isfinite(res.prefill_logits).all() and torch.isfinite(res.logits).all()


@pytest.mark.parametrize("arch,slice_name", [("musicgen-large", "ROADMAP queue 1 item 3"),
                                             ("granite-moe-1b-a400m", "ROADMAP queue 1 item 3"),
                                             ("deepseek-67b", "ROADMAP queue 1 item 3")])
def test_archs_not_ported_name_their_slice(arch, slice_name):
    """The archs that waited for ``slice_name`` (the seven the port did not
    run before it) are built now: at full width on ``meta``, before anything
    is allocated (deepseek-67b is 135 GB), and at smoke on the CPU, through
    ``build_model`` and through ``launch.serve``/``launch.train``."""
    from repro_torch.config import get_model_config
    from repro_torch.launch import serve, train
    from repro_torch.models import build_model
    full = build_model(get_model_config(arch), device="meta")
    assert sum(p.numel() for p in full.parameters()) > 1e9
    model = build_model(get_model_config(arch, smoke=True), device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert serve.build(arch, smoke=True, device="cpu").cfg == model.cfg
    assert train.setup(arch, smoke=True, device="cpu")[0].cfg == model.cfg
