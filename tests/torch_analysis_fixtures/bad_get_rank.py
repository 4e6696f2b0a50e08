"""Seeded LGB008 violation — rank identity from ``dist.get_rank()``
deciding whether a mesh collective runs.  This file is ONLY an
analysis-pass fixture; nothing imports it."""

import torch.distributed as dist


def reduce_on_root(mesh, hist):
    # BAD: only rank 0 enters the psum — every other rank waits in its
    # next collective for a peer that never comes
    if dist.get_rank() == 0:
        return mesh.psum(hist, "data")
    return hist
