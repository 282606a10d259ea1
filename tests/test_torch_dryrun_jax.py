"""The port's dry-run cells against the JAX package's (CPU): qwen1.5-0.5b
``train_4k`` and ``decode_32k`` on the 16 x 16 mesh, each run by its own
``launch.dryrun`` in a subprocess (JAX lowers and compiles the cell's step on 256 placeholder
devices, ~10 s; the port runs its split step on meta tensors as rank 0 of a
fake group of 256 ranks, ~20 s).

Both hold each rank's shards of the parameters and the AdamW moments under
the same ``ShardingRules``; the arguments differ only by the token ids and
labels, int64 in the port and int32 in JAX (4 bytes a token each), and by
JAX's step count, an int32 argument where the port keeps a host int. Each
rank's matmul FLOPs must lie within 0.75-1.25 of JAX's
``hlo_dot_flops_per_device``: the port computes tensor-parallel as GSPMD
partitions the JAX step (before it, every rank computed the whole model,
17.5 times JAX's count). The decode cell holds the rules' shards of the
parameters and of the caches (qwen's kv heads split over "model") as JAX's
does: the arguments differ by the token ids (8 rows a rank, int64 against
int32) and JAX's int32 position, which the port keeps as a host int.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCH, SHAPE = "qwen1.5-0.5b", "train_4k"
FLOP_RATIO = (0.75, 1.25)


def _dryrun(package: str, out: Path, extra=(), shape: str = SHAPE) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", f"{package}.launch.dryrun", "--arch", ARCH,
                           "--shape", shape, "--mesh", "single", "--out", str(out), "--force",
                           *extra], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((out / f"{ARCH}__{shape}__single.json").read_text())


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_jax")
    jax_cell = _dryrun("repro", d / "jax")
    port_cell = _dryrun("repro_torch", d / "port", ("--device", "cpu"))
    return jax_cell, port_cell


def test_arguments_equal_jax_but_for_token_dtype(cells):
    jax_cell, port = cells
    assert jax_cell["status"] == port["status"] == "OK"
    assert port["tensor_parallel"] is True
    # this rank's rows of tokens and labels: 256 rows over 16 data ranks
    tokens = 2 * (256 // 16) * 4096
    assert port["argument_size_in_bytes"] == port["argument_size_in_bytes_under_rules"]
    assert port["argument_size_in_bytes"] - jax_cell["argument_size_in_bytes"] == \
        tokens * (8 - 4) - 4


def test_matmul_flops_per_rank_near_jax(cells):
    jax_cell, port = cells
    ratio = port["hlo_dot_flops_per_device"] / jax_cell["hlo_dot_flops_per_device"]
    print(f"{ARCH} {SHAPE} 16x16: matmul FLOPs per rank, port / JAX = "
          f"{port['hlo_dot_flops_per_device']:.4e} / {jax_cell['hlo_dot_flops_per_device']:.4e}"
          f" = {ratio:.4f}")
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1], ratio


@pytest.fixture(scope="module")
def decode_cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_jax_decode")
    return (_dryrun("repro", d / "jax", shape="decode_32k"),
            _dryrun("repro_torch", d / "port", ("--device", "cpu"), shape="decode_32k"))


def test_decode_arguments_equal_jax_but_for_token_dtype(decode_cells):
    jax_cell, port = decode_cells
    assert jax_cell["status"] == port["status"] == "OK"
    assert port["tensor_parallel"] is True
    rows = 128 // 16                    # this rank's rows of the batch: 128 over 16 data ranks
    assert port["argument_size_in_bytes"] == port["argument_size_in_bytes_under_rules"]
    assert port["argument_size_in_bytes"] - jax_cell["argument_size_in_bytes"] == \
        rows * (8 - 4) - 4
