"""What the benchmark runs imports neither JAX nor the JAX package, and it
refuses to run without a card or without the program."""
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from bench import harness

ROOT = harness.ROOT
CELL = harness.benchmark()["workloads"][0]["name"]
ARGS = ["--workload", CELL, "--seed", "2147483653", "--seconds", "1", "--trace", "0"]

_PROBE = """
import importlib, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
mods = {mods!r}
for m in mods:
    importlib.import_module(m)
from bench import harness
for m in harness.benchmark()["end_to_end"] + harness.benchmark()["per_layer"]:
    harness.metric(m["name"])
if {drivers!r}:
    for d in ("train", "serve"):
        harness.driver(d)
top = {{n.split(".")[0] for n in sys.modules}}
print(sorted(top & {forbidden!r}))
"""


def _probe(mods, drivers, forbidden):
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"), mods=mods, drivers=drivers,
                         forbidden=set(forbidden))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr
    return p.stdout.strip().splitlines()[-1]


def test_harness_loads_no_jax():
    mods = ["bench.harness", "bench.trace", "bench.port", "bench.weights",
            "bench.drivers.train", "bench.drivers.serve", "bench.yardstick.compare"]
    assert _probe(mods, True, harness.FORBIDDEN) == "[]"


def test_reference_loads_nothing_of_the_program():
    mods = ["bench.reference.common", "bench.reference.ssm", "bench.reference.moe",
            "bench.weights", "bench.yardstick.compare", "bench.yardstick.cost"]
    assert _probe(mods, False, harness.FORBIDDEN + ("repro_torch",)) == "[]"


def test_no_file_names_jax_or_the_benchmarks_folder():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)(\.|\s|$)")
    files = [f for f in (ROOT / "bench").rglob("*.py") if "tests" not in f.parts]
    assert files
    for f in files:
        text = f.read_text()
        assert not any(pat.match(line) for line in text.splitlines()), f
        assert "benchmarks/" not in text and "benchmarks." not in text, f


def test_run_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), *ARGS],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stdout + p.stderr


def test_run_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stdout + p.stderr
