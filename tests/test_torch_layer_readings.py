"""CPU rehearsal of ``chip_smoke.py``'s layer-by-layer card checks, at the
smoke configs of qwen1.5-0.5b, mamba2-370m and recurrentgemma-2b (no JAX).

* Phase 17(e)'s per-layer reader (``readings.split_vs_whole`` over
  ``torch_mesh_harness.tp_layer_cases(arch)``) on 2 gloo ranks of a (1, 2)
  ("data", "model") mesh at the card's judged seeds: every split layer's
  output, input gradient and parameter gradients within half the card's
  limit (``chip_smoke.tp_layer_tol``), and each planted fault of
  ``TP_PLANTED_KIND`` at least ``TP_FAULT_FACTOR`` times the limit of the
  layer it breaks.
* Phase 17(f)'s bf16 split prefill layer by layer
  (``chip_smoke.split_layer_replays``) on the same ranks: the row-parallel
  sums bit-equal to their replay, each part within half its limit, and
  each named control over its limit.
* The served bf16 check layer by layer (``chip_smoke.layer_replays``, one
  process), a CPU model in place of the card's: every layer's parts within
  half their limits, each control planted in a middle layer at least
  ``LAYER_REPLAY_FACTOR`` times its part's limit there (``layer_replays``
  fails the run otherwise).
"""
import sys
from pathlib import Path

import pytest
import torch

import torch_mesh_harness as harness

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCHS = (chip_smoke.QWEN, chip_smoke.MAMBA, chip_smoke.RG)
LAYERS = [(a, k) for a in ARCHS for k in harness.tp_layer_cases(a)]
FAULTS = [(a, f) for a in ARCHS for f, k in harness.TP_PLANTED_KIND.items()
          if k in harness.tp_layer_cases(a)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("layer_readings") / "out.pt"
    return harness.run_ranks("layer_readings", {"archs": ARCHS,
                                                "seeds": chip_smoke.TP_LAYER_SEEDS},
                             out, shape=(1, 2), axes=("data", "model"))


@pytest.mark.parametrize("arch,kind", LAYERS)
def test_split_layer_within_half_its_card_limit(ranks, arch, kind):
    limit = chip_smoke.tp_layer_tol()[arch][kind]
    for seed, r in ranks["layers"]["archs"][arch][kind].items():
        assert max(r["out"], r["x_grad"], r["param_grad"]) <= limit / 2, (seed, r, limit)


@pytest.mark.parametrize("arch,fault", FAULTS)
def test_planted_fault_over_its_layer_limit(ranks, arch, fault):
    kind, r = ranks["layers"]["arch_planted"][arch][fault]
    limit = chip_smoke.tp_layer_tol()[arch][kind]
    assert max(r["out"], r["x_grad"], r["param_grad"]) >= chip_smoke.TP_FAULT_FACTOR * limit, r


@pytest.mark.parametrize("arch", ARCHS)
def test_split_prefill_layer_replays(ranks, arch):
    r = ranks["serve"][arch]
    assert r["sound"]["row-parallel sums"][0] == 0.0
    for key, (v, layer, limit) in r["sound"].items():
        assert v <= limit / 2, (key, v, layer, limit)
    assert set(r["planted"]) == set(chip_smoke.TP_LAYER_FAULTS[arch])
    for fault, readings in r["planted"].items():
        v, _, limit = readings[chip_smoke.TP_LAYER_FAULT_READS[fault]]
        assert v > limit, (fault, readings)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_layer_replays(arch):
    from repro_torch.launch import serve as launch_serve
    model = launch_serve.build(arch, smoke=True, device="cpu", seed=0).eval()
    r = chip_smoke.layer_replays(torch, model, arch, "cpu")
    assert len(r["sound"]) == model.cfg.num_layers
    for layer, parts in r["sound"].items():
        assert set(parts) >= {"op", "mixer"}, parts
        for part, v in parts.items():
            assert v <= r["limits"][layer][part] / 2, (layer, part, v)
    assert [f for f, *_ in chip_smoke.LAYER_REPLAY_FAULTS[arch]] == list(r["planted"])
    for fault, c in r["planted"].items():
        assert 0 < c["layer"] < model.cfg.num_layers - 1 or model.cfg.num_layers <= 2
        limit = r["limits"][c["layer"]][c["part"]]
        assert c["readings"][c["part"]] >= chip_smoke.LAYER_REPLAY_FACTOR * limit, (fault, c)
