"""Small copies of the cells' configurations and mixes, for the CPU tests:
every width cut, the structure kept (two layers, several SSD chunks, GQA,
experts whose capacity binds), and the limits on the same numbers that each
cell compares, at this size. Each comes from the cell's own files: the
configuration's and the mix's ``small`` keys, the cell's ``small_limits``.

The gaps grow with depth and width, so the cells' own limits, set on the
card at full size, say nothing here. Each small limit lies between the
readings of the program over seeds 1-8 at these sizes on the CPU and the
least that the fp8 control or a planted fault gives on seeds 1-3 there
(``PERF.md`` gives both).
"""
from bench import harness

SEED = 2 ** 31 + 77


def config(name: str) -> dict:
    cfg = harness.config(name)
    cfg.update(cfg["small"])
    return cfg


def mix(name: str) -> dict:
    m = harness.mix(name)
    m.update(m["small"])
    return m


def limits(cell: str) -> dict:
    return harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")["small_limits"]


def run(cell: str, fault=None, traced=False, seed=SEED, **kw) -> dict:
    w = harness.cell(cell)
    return harness.run(cell, seed, 0.05, traced, "cpu", 0.0, fault=fault,
                       cfg=kw.pop("cfg", None) or config(w["config"]),
                       mx=kw.pop("mx", None) or mix(w["traffic"]),
                       lim=kw.pop("lim", None) or limits(cell), **kw)
