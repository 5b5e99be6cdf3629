"""Meshes over the running ranks (port of ``repro.launch.mesh``'s host
mesh).  A function, not a module-level constant: importing touches no
process group or device.  The production mesh waits for the LM substrate
(ROADMAP A10)."""
from __future__ import annotations

import torch.distributed as dist

from ..core.distributed import make_search_mesh
from ..kernels.common import Device


def make_host_mesh(model: int = 1, *, device: Device = None):
    """A (data, model) mesh over every rank of the running process group:
    ``model`` ranks a shard group, the rest of the world along ``data``
    (one rank: (1, 1)).  ``device`` as :func:`make_search_mesh`'s."""
    n = dist.get_world_size()
    data = max(n // model, 1)
    return make_search_mesh(data, model, device=device)
