"""Host-side native code (C++ packer, BM25 scorers, answer-span matcher)
and its g++ build."""
from viquae_torch.native.build import (  # noqa: F401
    load_answer_span_matcher,
    load_bm25_maxscore,
    load_bm25_maxscore_mt,
    load_bm25_scorer,
    load_packer,
)
