"""Interactive QA demo (parity meerqat/interact/system.py:24-73, with the
reader step the reference left as TODO actually implemented).

Online single-query path: embed image (CLIP/face chains) -> embed question
text (DPR) -> Searcher over all indexes -> Fusion -> top passages ->
extractive reader -> answer span.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


class System:
    """Wires embedders + searcher + fusion + reader for one query at a time.

    Parameters
    ----------
    text_embedder: TextEmbedder for the question.
    image_embedders: {column_name: callable(pil_image) -> np.ndarray} visual
        query embedders (CLIP image, ArcFace face, ...).
    searcher: viquae_torch.ir.search.Searcher.
    fusion: viquae_torch.ir.fuse.Fusion (fitted) or None for single index.
    fusion_params: wsum weights etc. for Fusion.test.
    reader_fn: callable(question, passages, scores) -> answer str, optional.
    kb: passage dataset for displaying results.
    """

    def __init__(self, text_embedder, searcher, image_embedders=None,
                 fusion=None, fusion_params=None, reader_fn=None, kb=None,
                 k: int = 10):
        self.text_embedder = text_embedder
        self.image_embedders = image_embedders or {}
        self.searcher = searcher
        self.fusion = fusion
        self.fusion_params = fusion_params or {}
        self.reader_fn = reader_fn
        self.kb = kb
        self.k = k

    def __call__(self, question: str, image=None) -> Dict:
        # clear state from the previous query: the Searcher accumulates runs
        # and relevance caches by query id, and a stale 'interactive' entry
        # would otherwise be returned for every later question
        for run in self.searcher.runs.values():
            run.pop("interactive", None)
        self.searcher.qrels.pop("interactive", None)
        self.searcher.qnonrels.pop("interactive", None)
        batch = {
            "id": ["interactive"],
            "output": [{"original_answer": "", "answer": []}],
        }
        batch[self.text_embedder.save_as] = [
            self.text_embedder.embed_texts([question])[0]
        ]
        batch[self.text_embedder.key] = [question]
        for column, embedder in self.image_embedders.items():
            batch[column] = [embedder(image) if image is not None else None]
        self.searcher(batch)

        runs = {
            name: dict(run.get("interactive", {}))
            for name, run in self.searcher.runs.items()
        }
        if self.fusion is not None and len(runs) > 1:
            import copy

            from viquae_torch.rankeval import Run

            # shallow copy: the caller's fitted Fusion keeps its offline
            # runs/qrels/output — mutating the shared object would wipe
            # its qrels after the first question and overwrite
            # output/test_run.json on every interactive query
            fusion = copy.copy(self.fusion)
            fusion.runs = [
                Run({"interactive": r}, name=n) for n, r in runs.items()
            ]
            fusion.qrels = None
            fusion.output = None
            combined = fusion.test(self.fusion_params, metrics=[])
            results = combined["interactive"]
        else:
            results = next(iter(runs.values())) if runs else {}
        ranked = sorted(results.items(), key=lambda kv: -kv[1])[: self.k]

        passages: List[str] = []
        if self.kb is not None:
            passages = [
                self.kb[int(doc_id)][self.searcher.reference_key]
                for doc_id, _ in ranked
            ]
        answer = None
        if self.reader_fn is not None and passages:
            answer = self.reader_fn(
                question, passages, [s for _, s in ranked]
            )
        return {
            "results": ranked,
            "passages": passages,
            "answer": answer,
        }

    def repl(self):  # pragma: no cover - interactive
        while True:
            question = input("Question (empty to quit): ").strip()
            if not question:
                return
            image_path = input("Image path (optional): ").strip() or None
            image = None
            if image_path:
                from PIL import Image

                image = Image.open(image_path).convert("RGB")
            out = self(question, image)
            for i, (doc, score) in enumerate(out["results"]):
                text = out["passages"][i][:100] if out["passages"] else ""
                print(f"{i + 1}. [{score:.3f}] {doc} {text}")
            if out["answer"]:
                print(f"=> {out['answer']}")
