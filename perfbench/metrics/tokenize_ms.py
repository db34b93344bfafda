"""Host wall of WordPiece on one batch of the packed question embedder:
the mean of the window's ``embed.tokenize`` spans
(``PackedTextEmbedder.pack``'s ``BertTokenizerFast`` call), a part of
``host_ms_per_batch``."""
from perfbench.recorder import mean_ms, spans


def read(run):
    return mean_ms([s.seconds for s in spans("embed.tokenize")])
