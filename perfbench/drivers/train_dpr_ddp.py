"""``train_dpr_ddp``: ``TrainDPR``'s job data-parallel over the cell's
ranks, one a card, as ``torchrun`` runs the port's training.

Every rank draws the same towers and the same batches from the seed and
builds the port's ``Trainer`` on a mesh with every rank on ``data``
(``core.mesh.make_mesh`` over the process group the harness joined). Each
call is one ``Trainer.fit`` step on the global batch, collated whole on
every rank: the trainee encodes this rank's block of each packed canvas's
rows, gathers the [CLS] states over ``data``, scores every question
against every passage of the global batch (global in-batch negatives),
and the trainer averages the gradients in one all-reduce. Rank 0 decides
before each step whether the window is still open and tells the others
from the host (``ranks.closed_loop``), so that every rank takes the same
steps. Set-up's judged steps, the readings and the reference are
``TrainDPR``'s: rank 0 judges the global batch.

Its rate is ``train_items_per_s``: the global batch's questions over
completed steps. Each rank's host threads follow its share of the CPUs
(``perfbench/ranks.py``).
"""
from __future__ import annotations

import torch.distributed as dist

from perfbench import entries, gen, ranks, roofline

# the mesh of each process group this process joined
_MESHES: dict = {}


def data_mesh(device):
    """Every rank on ``data``: one mesh a process group, built once."""
    from viquae_torch.core import mesh as meshlib

    key = (str(device), id(dist.group.WORLD) if dist.is_initialized()
           else None)
    if key not in _MESHES:
        _MESHES[key] = meshlib.make_mesh(device=device)
    return _MESHES[key]


class TrainDPRDDP(entries.TrainDPR):

    def build(self):
        from viquae_torch.core import mesh as meshlib

        with meshlib.use(data_mesh(self.device)):
            super().build()

    def window(self, seconds):
        self.collate_s = []
        steps, wall = ranks.closed_loop(
            seconds, lambda i: self.step(self.done + i), self.device)
        n, width = self.traf["batch"], self.b["hidden_size"]
        flops = 0.0
        for c in range(steps):
            qs, pos, neg = gen.cycle(self.steps, self.done + c)
            for texts in (qs, pos + neg):
                flops += roofline.encoder_flops(
                    self.b, [gen.token_count(t) for t in texts], train=True)
            # the similarities' product and its two gradients
            flops += 3 * 2.0 * n * 2 * n * width
        items = steps * n
        return entries.Window({"train_items_per_s": items / wall}, items, 0, {
            "wall_s": wall, "steps": steps, "model_flops": flops,
            "peak_flops": ranks.size() * roofline.PEAKS[
                self.conf["train"]["dtype"]],
            "collate_s": list(self.collate_s)},
            {"ranks": ranks.size()})


ENTRY = TrainDPRDDP
