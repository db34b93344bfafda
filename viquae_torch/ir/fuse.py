"""Late fusion driver (parity with meerqat/ir/fuse.py:162-237).

`Fusion.fit` grid-searches fusion parameters (wsum weights on the simplex)
against qrels; `Fusion.test` applies best params and evaluates. Custom norms
(the reference's numba gzmuv, ir/fuse.py:86-129) and default-minimum
imputation (:132-149) live in viquae_torch.rankeval.fusion as vectorized
numpy and are applied as pre-processing, exactly like the reference routes
custom norms around ranx.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Union

from viquae_torch.ir.metrics import fuse_qrels
from viquae_torch.rankeval import (
    Qrels,
    Run,
    default_minimum,
    evaluate,
    fuse,
    normalize_run,
    optimize_fusion,
)

CUSTOM_NORMS = ("gzmuv",)


class Fusion:
    def __init__(
        self,
        qrels: Union[str, Path, Qrels, List[str], None] = None,
        runs: Optional[List] = None,
        norm: Union[str, None, List[Optional[str]]] = "zmuv",
        method: Union[str, None, List[Optional[str]]] = "wsum",
        output: Optional[str] = None,
        defmin: bool = False,
    ):
        if isinstance(qrels, Qrels) or qrels is None:
            self.qrels = qrels
        elif isinstance(qrels, (str, Path)):
            self.qrels = Qrels.from_file(qrels)
        else:
            self.qrels = fuse_qrels(qrels)
        runs = runs or []
        self.runs = [
            r if isinstance(r, Run) else Run.from_file(r) for r in runs
        ]
        if defmin:
            self.runs = default_minimum(self.runs)
        self.norm = norm
        self.method = method
        if output is not None:
            output = Path(output)
            output.mkdir(exist_ok=True, parents=True)
        self.output = output

    def _apply_norm(self, runs, norm):
        """Custom norms run as pre-processing; built-ins pass through."""
        if norm in CUSTOM_NORMS:
            return [normalize_run(r, norm) for r in runs], None
        return runs, norm

    def fit(self, metric: str = "mrr@100", step: float = 0.1) -> dict:
        """Finds best parameters for each (norm, method) combination."""
        norms = [self.norm] if (self.norm is None or isinstance(self.norm, str)) else self.norm
        methods = [self.method] if (self.method is None or isinstance(self.method, str)) else self.method
        all_best = {}
        for norm in norms:
            runs, norm_inner = self._apply_norm(self.runs, norm)
            for method in methods:
                best_params, report = optimize_fusion(
                    qrels=self.qrels, runs=runs, norm=norm_inner,
                    method=method, metric=metric, step=step,
                    return_optimization_report=True,
                )
                print(
                    f"Norm: {norm}, Method: {method}. "
                    f"Best parameters: {best_params}."
                )
                all_best[(norm, method)] = best_params
                if self.output is not None:
                    with open(
                        self.output / f"{norm}_{method}_best_params.json",
                        "w"
                    ) as f:
                        # JSON, because `fuse test --best_params` (cli.py)
                        # loads this file with json.loads — the fit->test
                        # round-trip crashed on the previous yaml.dump
                        json.dump(best_params, f, indent=1)
        return all_best

    @staticmethod
    def _single(value, what):
        """fit() accepts lists of norms/methods; test() needs exactly one."""
        if isinstance(value, list):
            if len(value) != 1:
                raise ValueError(
                    f"Fusion.test needs a single {what}, got {value!r}; "
                    "re-instantiate with the winning one from fit()"
                )
            return value[0]
        return value

    def test(self, best_params: dict, metrics: Optional[List[str]] = None) -> Run:
        """Applies best parameters; returns (and saves) the combined run."""
        if metrics is None:
            metrics = ["mrr@100", "precision@1", "precision@20", "hit_rate@20"]
        norm = self._single(self.norm, "norm")
        method = self._single(self.method, "method")
        runs, norm = self._apply_norm(self.runs, norm)
        combined = fuse(
            runs=runs, norm=norm, method=method, params=best_params
        )
        if self.output is not None:
            combined.save(self.output / "test_run.json")
        if metrics and self.qrels is not None:
            results = evaluate(self.qrels, combined, metrics)
            print(results)
            if self.output is not None:
                with open(self.output / "fusion_metrics.json", "w") as f:
                    json.dump(results, f, indent=2)
        return combined
