"""Seeded LGB008 violation — ``dist.all_reduce`` on one branch of a
condition on the mesh's coordinates.  This file is ONLY an analysis-pass
fixture; nothing imports it."""

import torch.distributed as dist


class Exchange:
    def __init__(self, mesh):
        self.mesh = mesh

    def counts(self, c):
        # BAD: the first row of the grid reduces, the others do not
        if self.mesh.coords[0] == 0:
            dist.all_reduce(c)
        return c
