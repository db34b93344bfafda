"""Dataset statistics (role of meerqat/viz/stats.py): per-column coverage,
answer/question length distributions, face counts."""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import numpy as np


def dataset_stats(dataset, columns: Optional[list] = None) -> Dict:
    columns = columns or getattr(dataset, "column_names", None) or []
    stats: Dict = {"n_items": len(dataset)}
    for column in columns:
        try:
            values = dataset[column]
        except (KeyError, TypeError):
            continue
        n_none = sum(1 for v in values if v is None)
        stats[column] = {"coverage": 1 - n_none / max(len(values), 1)}
        sample = next((v for v in values if v is not None), None)
        if isinstance(sample, str):
            lengths = [len(v.split()) for v in values if v is not None]
            if lengths:
                stats[column].update(
                    mean_words=float(np.mean(lengths)),
                    max_words=int(np.max(lengths)),
                )
        elif isinstance(sample, list):
            lengths = [len(v) for v in values if v is not None]
            if lengths:
                stats[column]["mean_len"] = float(np.mean(lengths))
                stats[column]["len_hist"] = dict(Counter(lengths))
    return stats
