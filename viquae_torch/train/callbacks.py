"""Post-fit hooks (counterpart of viquae_tpu/train/callbacks.py)."""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable

from viquae_torch.train import checkpoint as ckpt_lib


def test_after_fit(trainer, eval_batches_fn: Callable[[], Iterable],
                   use_best: bool = True) -> dict:
    """Evaluate with the best (or last) checkpoint after training (the
    reference reloads the best ModelCheckpoint and runs trainer.test)."""
    cfg = trainer.cfg
    if use_best and cfg.ckpt_dir:
        best_dir = Path(cfg.ckpt_dir) / "best"
        if ckpt_lib.all_steps(best_dir):
            ckpt_lib.restore_state(best_dir, trainer.state,
                                   map_location=trainer.device)
    return trainer.evaluate(eval_batches_fn())
