"""Export trained checkpoints as standalone encoder dirs (counterpart of
viquae_tpu/train/save_ptm.py).

Turns a train-state checkpoint (``checkpoint.save_state``) into
params-only export directories in the JAX package's ``params.npz``
format — the inter-stage contract that ir.embedding and either package's
``from_pretrained`` read.
"""
from __future__ import annotations

from pathlib import Path

from viquae_torch.models.convert import tree_from_module
from viquae_torch.train import checkpoint as ckpt_lib


def save_ptm(ckpt_dir, output_dir, template_state, subtree: str = "params",
             split_keys=("question", "context"), step=None):
    """Restore a train state (``template_state``: a
    ``trainer.TrainState``) and export its params' sub-modules named in
    ``split_keys`` (or all of them) as ``<key>_model`` dirs."""
    state, step = ckpt_lib.restore_state(ckpt_dir, template_state, step=step)
    params = state[subtree] if subtree else state
    output_dir = Path(output_dir)
    exported = []
    names = [k for k in split_keys if k in params._modules]
    if names:
        for key in names:
            ckpt_lib.export_params(output_dir / f"{key}_model",
                                   tree_from_module(params[key]))
            exported.append(str(output_dir / f"{key}_model"))
    else:
        ckpt_lib.export_params(output_dir, tree_from_module(params))
        exported.append(str(output_dir))
    return {"step": step, "exported": exported}
