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

JAX's train_4k subprocess also lists its compiled HLO's all-reduces (by
shape, dtype, replica groups, reducer and loop trip count, through
``repro.launch.hlo_analysis``'s parse of the same module): the activations'
all-reduces over "model" are f32, the host compiler's promotion of bf16
sums (``clone_promoted`` reducers), and the port's intra-pod bytes equal
JAX's scaled by bf16 / f32 and by the port's count of activation
all-reduces over JAX's, within 2%.
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


# The port's activation-size all-reduces over "model" in one train_4k step:
# five a layer (the attention's and the MLP's row-parallel outputs, the
# attention's again in the block's recompute, the two column-parallel
# inputs' gradients), the embedding's lookup and the loss's hidden states'
# gradient (pinned in tests/test_torch_dryrun.py, test_run_cell_train_multi_pod)
PORT_ACT_ALL_REDUCES = 5 * 24 + 2
# lists the compiled module's all-reduces beside the dry run of the same
# compile: launch.dryrun's main, with its collective summary's HLO kept
_LIST_ALL_REDUCES = """
import collections, json, re, sys
from repro.launch import dryrun
from repro.launch import hlo_analysis as H
texts = []
summary = dryrun.collective_summary
dryrun.collective_summary = lambda text, mp: (texts.append(text), summary(text, mp))[1]
out = sys.argv[1]
sys.argv = ["dryrun", *sys.argv[2:]]
dryrun.main()
comps = H.parse_hlo_module(texts[0])
mult = collections.Counter()

def walk(c, m):
    mult[c.name] += m
    for body, cond in c.whiles:
        if body in comps:
            walk(comps[body], m * max(comps[cond].max_const if cond in comps else 1, 1))
    for name in c.calls + c.fusion_calls:
        if name in comps:
            walk(comps[name], m)

walk(comps["__entry__"], 1)
found, cur = collections.Counter(), None
for raw in texts[0].splitlines():
    st = raw.strip()
    head = H._COMP_START_RE.match(st)
    if head and st.endswith("{"):
        cur = head.group(1)
    elif " all-reduce(" in st and cur is not None:
        result = st.split("=", 1)[1].split(" all-reduce(")[0]
        groups = re.search(r"replica_groups=(\\[[^\\]]*\\]<=\\[[^\\]]*\\](T\\([0-9,]*\\))?)", st)
        reducer = re.search(r"to_apply=%?([\\w.\\-]+)", st).group(1)
        for dtype, dims in re.findall(r"(\\w+)\\[([0-9,]*)\\]", result):
            found[(dtype, dims, groups.group(1), reducer)] += mult[cur]
with open(out, "w") as f:
    json.dump([[*k, n] for k, n in found.items()], f)
"""


def _dryrun(package: str, out: Path, extra=(), shape: str = SHAPE, all_reduces=None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    args = ["--arch", ARCH, "--shape", shape, "--mesh", "single", "--out", str(out), "--force",
            *extra]
    cmd = ([sys.executable, "-c", _LIST_ALL_REDUCES, str(all_reduces), *args] if all_reduces
           else [sys.executable, "-m", f"{package}.launch.dryrun", *args])
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((out / f"{ARCH}__{shape}__single.json").read_text())


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_jax")
    jax_cell = _dryrun("repro", d / "jax", all_reduces=d / "all_reduces.json")
    jax_cell["all_reduces"] = json.loads((d / "all_reduces.json").read_text())
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


def test_intra_pod_bytes_match_jax_after_dtype_and_count(cells):
    """JAX's activation all-reduces over "model" (replica groups of 16
    consecutive ranks, [rows, 4096, 1024]) are f32 sums of bf16 products
    that the host compiler promoted (every reducer ``*clone_promoted``);
    the port sums them in bf16, and makes fewer of them. Scaled by both,
    the port's intra-pod bytes a rank are JAX's within 2%."""
    jax_cell, port = cells
    rows = 256 // 16
    act = [(dtype, reducer, n) for dtype, dims, groups, reducer, n in jax_cell["all_reduces"]
           if dims == f"{rows},4096,1024"]
    model_groups = {groups for _, dims, groups, _, _ in jax_cell["all_reduces"]
                    if dims == f"{rows},4096,1024"}
    assert model_groups == {"[16,16]<=[256]"}, model_groups
    assert {dtype for dtype, _, _ in act} == {"f32"}, act
    assert all(reducer.endswith("clone_promoted") for _, reducer, _ in act), act
    jax_count = sum(n for *_, n in act)
    scaled = port["intra_pod_bytes_per_device"] * (4 / 2) * jax_count / PORT_ACT_ALL_REDUCES
    ratio = scaled / jax_cell["intra_pod_bytes_per_device"]
    print(f"{ARCH} {SHAPE} 16x16: JAX's activation all-reduces over model {jax_count} (f32), "
          f"the port's {PORT_ACT_ALL_REDUCES} (bf16); intra-pod bytes a rank, port "
          f"{port['intra_pod_bytes_per_device']:.4e} x 2 x {jax_count} / "
          f"{PORT_ACT_ALL_REDUCES} = {scaled:.4e} against JAX's "
          f"{jax_cell['intra_pod_bytes_per_device']:.4e} ({ratio:.4f})")
    assert abs(ratio - 1.0) <= 0.02, ratio


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
