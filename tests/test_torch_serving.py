"""The whole ported slice: tokenize -> pack -> packed DPR encoder -> fused
exact search, through FusedRetrievalPipeline, against the JAX pipeline on
the same tokenizer, weights, queries and KB."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import bf16_ulp_distance
from viquae_torch.ir.embedding import PackedTextEmbedder as TEmbedder
from viquae_torch.ir.serving import FusedRetrievalPipeline as TFused
from viquae_torch.ir.serving import RetrievalPipeline as TPipeline
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import dpr as tdpr
from viquae_torch.ops import mips as tm
from viquae_tpu.ir.embedding import PackedTextEmbedder as JEmbedder
from viquae_tpu.ir.serving import FusedRetrievalPipeline as JFused
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.ops import mips as jm

torch.set_num_threads(2)

SMALL = dict(vocab_size=3000, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64, add_pooler=False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from transformers import BertTokenizerFast

    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"w{i}" for i in range(2000)])
    d = tmp_path_factory.mktemp("servetok")
    (d / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(d / "vocab.txt"))
    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(**SMALL))
    tcfg = tdpr.DPRConfig(bert=tbert.BertConfig(**SMALL))
    tree = jax.tree.map(np.asarray, jdpr.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    queries = [
        " ".join(f"w{j}" for j in rng.integers(0, 2000, rng.integers(4, 15)))
        for _ in range(150)
    ]
    kb = rng.normal(size=(5000, 32)).astype(np.float32)
    return tok, jcfg, tcfg, tree, queries, kb


def _port_pipeline(setup, do_l2norm=False, k=10):
    tok, _, tcfg, tree, _, kb = setup
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    emb = TEmbedder(tdpr.make_packed_apply(tcfg), model, tok, row_len=32,
                    batch_size=64, compute_dtype=torch.float32, device="cpu")
    index = tm.DenseIndex(kb, do_l2norm=do_l2norm, mode="fused",
                          device="cpu")
    return TFused(emb, index, batch_size=64, k=k)


def _jax_pipeline(setup, do_l2norm=False, k=10):
    tok, jcfg, _, tree, _, kb = setup
    emb = JEmbedder(jdpr.make_packed_apply(jcfg),
                    jax.tree.map(jnp.asarray, tree), tok, row_len=32,
                    batch_size=64, compute_dtype=jnp.float32)
    index = jm.DenseIndex(kb, do_l2norm=do_l2norm, mode="fused")
    return JFused(emb, index, batch_size=64, k=k)


@pytest.mark.parametrize("do_l2norm", [False, True], ids=["ip", "l2norm"])
def test_fused_pipeline_matches_jax(setup, do_l2norm):
    """f32 encoders on both sides; the search casts the embeddings to bf16.
    The two f32 embeddings differ in the last bits, so a bf16 cast can land
    one ulp apart and swap near-tied KB rows: ids equal on >= 99 % of
    positions, every score within 2 bf16 ulps of the JAX score."""
    queries = setup[4]
    scores, idx = _port_pipeline(setup, do_l2norm).run_arrays(queries)
    ref_s, ref_i = _jax_pipeline(setup, do_l2norm).run_arrays(queries)
    assert scores.shape == idx.shape == (150, 10)
    assert scores.dtype == np.float32 and idx.dtype == np.int64
    assert np.mean(idx == ref_i) >= 0.99
    assert bf16_ulp_distance(scores, ref_s).max() <= 2


def test_run_device_matches_run_arrays(setup):
    queries = setup[4]
    pipe = _port_pipeline(setup)
    scores, idx = pipe.run_arrays(queries)
    batches = pipe.run_device(queries)
    assert [start for start, _, _ in batches] == [0, 64, 128]
    got_i = np.concatenate([
        i[: min(64, len(queries) - start)].numpy()
        for start, _, i in batches])
    got_s = np.concatenate([
        s[: min(64, len(queries) - start)].float().numpy()
        for start, s, _ in batches])
    np.testing.assert_array_equal(got_i, idx)
    np.testing.assert_array_equal(got_s, scores)
    assert batches[0][1].dtype == torch.bfloat16
    assert batches[0][2].dtype == torch.int32


def test_base_pipeline_and_index_search_agree_with_fused(setup):
    """RetrievalPipeline (embed, then DenseIndex.search_batch) returns the
    same ids and scores as the fused pipeline, and the k clamp holds."""
    queries = setup[4]
    fused = _port_pipeline(setup)
    scores, idx = fused.run_arrays(queries)
    base = TPipeline(fused.embed_fn, fused.index, batch_size=64, k=10)
    b_scores, b_idx = base.run_arrays(queries)
    np.testing.assert_array_equal(b_idx, idx)
    np.testing.assert_array_equal(b_scores, scores)
    assert set(base.report()) == {"tokenize+embed_dispatch",
                                  "search_dispatch", "drain_to_host"}
    small = tm.DenseIndex(setup[5][:7], mode="fused", device="cpu")
    s7, i7 = TFused(fused.embed_fn, small, batch_size=64,
                    k=100).run_arrays(queries[:10])
    assert s7.shape == i7.shape == (10, 7)
    assert i7.max() < 7


def test_fused_pipeline_rejects_other_modes(setup):
    class Chunked:
        mode, n = "fast", 10

    with pytest.raises(ValueError, match="single-pass"):
        TFused(None, Chunked())
