"""The paper's own experiment grid (Fig. 3 setup), as config objects: the
JAX package's ``configs/paper.py`` over the port's ``NetConfig``.

Topology: two AI-DCs, 16 bidirectional 100 Gbps OTN links, intra-DC one-way
delay 1 us, distance swept 1..1000 km (5 us .. 5 ms one-way), message sizes
1 KB..8 MB, concurrency 1..64.
"""
from __future__ import annotations

import dataclasses

from repro_torch.config.net import NetConfig

# Distance sweep (km) used in Fig. 3(b)-(d)
DISTANCES_KM = (1.0, 10.0, 50.0, 100.0, 300.0, 500.0, 1000.0)

# Message sizes (bytes) used in Fig. 3(b,e)
MESSAGE_SIZES = (1 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20, 8 << 20)

# Parallel-message concurrency sweep
CONCURRENCY = (1, 4, 16, 64)

SCHEMES = ("dcqcn", "pseudo_ack", "themis", "matchrdma")

BASE_NET = NetConfig()


def net_at(distance_km: float, **over) -> NetConfig:
    return dataclasses.replace(BASE_NET, distance_km=distance_km, **over)
