"""The port's dataset embedders (viquae_torch/ir/embedding.py) against the
JAX ones on the same tokenizer, weights and texts: f32 embeddings within
1e-5; packed canvases and the host-side joins equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.ir import embedding as temb
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import dpr as tdpr
from viquae_tpu.ir import embedding as jemb
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr

torch.set_num_threads(2)

SMALL = dict(vocab_size=300, hidden_size=24, num_hidden_layers=3,
             num_attention_heads=2, intermediate_size=48,
             max_position_embeddings=64)
TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("input_ids", "segment_ids", "position_ids", "cls_rows",
          "cls_cols")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from transformers import BertTokenizerFast

    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"w{i}" for i in range(200)])
    d = tmp_path_factory.mktemp("embtok")
    (d / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(d / "vocab.txt"))
    rng = np.random.default_rng(0)

    def tree(cfg, init):
        t = jax.tree.map(np.asarray, init(jax.random.key(0), cfg))
        return jax.tree.map(
            lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(
                np.float32), t)

    bert_tree = tree(jbert.BertConfig(**SMALL), jbert.init)
    dpr_tree = tree(jdpr.DPRConfig(
        bert=jbert.BertConfig(**SMALL, add_pooler=False)), jdpr.init)
    texts = [
        " ".join(f"w{j}" for j in rng.integers(0, 200, rng.integers(3, 30)))
        for _ in range(21)]
    return tok, bert_tree, dpr_tree, texts


def _text_embedders(setup, **kw):
    tok, bert_tree, _, _ = setup
    jcfg, tcfg = jbert.BertConfig(**SMALL), tbert.BertConfig(**SMALL)
    ours = temb.TextEmbedder(
        functools.partial(tbert.apply, cfg=tcfg),
        convert.params_from_jax(bert_tree, tcfg, device="cpu"), tok,
        max_length=32, batch_size=8, device="cpu", **kw)
    ref = jemb.TextEmbedder(
        lambda params, **inputs: jbert.apply(params, jcfg, **inputs),
        jax.tree.map(jnp.asarray, bert_tree), tok, max_length=32,
        batch_size=8, **kw)
    return ours, ref


def _packed_embedders(setup, cls_t, cls_j, **kw):
    tok, _, dpr_tree, _ = setup
    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(**SMALL, add_pooler=False))
    tcfg = tdpr.DPRConfig(bert=tbert.BertConfig(**SMALL, add_pooler=False))
    ours = cls_t(tdpr.make_packed_apply(tcfg),
                 convert.params_from_jax(dpr_tree, tcfg, device="cpu"), tok,
                 row_len=32, batch_size=8, compute_dtype=torch.float32,
                 device="cpu", **kw)
    ref = cls_j(jdpr.make_packed_apply(jcfg),
                jax.tree.map(jnp.asarray, dpr_tree), tok, row_len=32,
                batch_size=8, compute_dtype=jnp.float32, **kw)
    return ours, ref


def test_bert_apply_hidden_states_match_jax(setup):
    """hidden_states[i] as the JAX bert.apply numbers them: 0 is the
    embedding output, i the output of layer i."""
    tok, bert_tree, _, texts = setup
    jcfg, tcfg = jbert.BertConfig(**SMALL), tbert.BertConfig(**SMALL)
    enc = tok(texts[:5], padding="max_length", truncation=True,
              max_length=32, return_tensors="np")
    ids = enc["input_ids"].astype(np.int32)
    mask = enc["attention_mask"].astype(np.int32)
    model = convert.params_from_jax(bert_tree, tcfg, device="cpu")
    with torch.no_grad():
        out = tbert.apply(model, tcfg, torch.from_numpy(ids),
                          attention_mask=torch.from_numpy(mask),
                          output_hidden_states=True)
        plain = tbert.apply(model, tcfg, torch.from_numpy(ids),
                            attention_mask=torch.from_numpy(mask))
    ref = jbert.apply(jax.tree.map(jnp.asarray, bert_tree), jcfg,
                      jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                      output_hidden_states=True)
    assert "hidden_states" not in plain
    assert len(out["hidden_states"]) == len(ref["hidden_states"]) == 4
    real = mask == 1
    for ours, theirs in zip(out["hidden_states"], ref["hidden_states"]):
        np.testing.assert_allclose(ours.numpy()[real],
                                   np.asarray(theirs)[real], **TOL)
    np.testing.assert_array_equal(out["hidden_states"][-1].numpy(),
                                  out["last_hidden_state"].numpy())
    np.testing.assert_array_equal(plain["last_hidden_state"].numpy(),
                                  out["last_hidden_state"].numpy())


@pytest.mark.parametrize("output_key", ["pooler_output",
                                        "last_hidden_state"])
def test_text_embedder_matches_jax(setup, output_key):
    texts = setup[3]
    ours, ref = _text_embedders(setup, output_key=output_key)
    a, b = ours.embed_texts(texts), ref.embed_texts(texts)
    assert a.dtype == np.float32 and a.shape == np.asarray(b).shape
    if output_key == "last_hidden_state":
        a, b = a[:, 0], np.asarray(b)[:, 0]   # pad positions are free
    np.testing.assert_allclose(a, b, **TOL)
    batch = ours({"passage": texts[:3]})
    np.testing.assert_array_equal(
        batch["embedding"][:, 0] if output_key == "last_hidden_state"
        else batch["embedding"], a[:3])
    for name, arr in ours.tokenize(texts[:3]).items():
        np.testing.assert_array_equal(arr, ref.tokenize(texts[:3])[name])
        assert arr.dtype == np.int32


def test_text_embedder_layers_and_empty_batch_match_jax(setup):
    texts = setup[3]
    ours, ref = _text_embedders(
        setup, layers=[0, 2, 3], save_as="cls",
        extra_input_fn=lambda batch, texts: [f"{t} w1" for t in texts])
    a = ours({"passage": list(texts)})
    b = ref({"passage": list(texts)})
    assert "cls" not in a
    for layer in (0, 2, 3):
        name = f"cls_layer_{layer}"
        assert a[name].shape == (len(texts), 24)
        np.testing.assert_allclose(a[name], b[name], **TOL)
    assert not np.allclose(a["cls_layer_2"], a["cls_layer_3"])
    empty, ref_empty = ours.embed_texts([]), ref.embed_texts([])
    assert len(empty) == len(ref_empty) == 3
    assert all(e.shape == (0, 24) and e.dtype == np.float32 for e in empty)
    pooled, ref_pooled = _text_embedders(setup)
    assert pooled.embed_texts([]).shape == ref_pooled.embed_texts(
        []).shape == (0, 24)


def test_pad_batch_matches_jax():
    rng = np.random.default_rng(0)
    arrays = {"a": rng.integers(0, 9, (3, 5)).astype(np.int32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    ours, n = temb.pad_batch(arrays, 8)
    ref, n_ref = jemb.pad_batch(arrays, 8)
    assert n == n_ref == 3
    for name in arrays:
        np.testing.assert_array_equal(ours[name], ref[name])
        assert ours[name].dtype == ref[name].dtype
    same, n = temb.pad_batch(arrays, 3)
    assert same is arrays and n == 3


def test_packed_column_embedder_matches_jax(setup):
    texts = setup[3]
    ours, ref = _packed_embedders(
        setup, temb.PackedColumnEmbedder, jemb.PackedColumnEmbedder,
        key="text", save_as="emb",
        extra_input_fn=lambda batch, texts: [
            f"{t} {title}" for t, title in zip(texts, batch["title"])])
    batch = {"text": list(texts), "title": [f"w{i}" for i in range(21)]}
    a, b = ours(dict(batch))["emb"], ref(dict(batch))["emb"]
    assert a.shape == (21, 24) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, **TOL)
    # the f32 default of the column adapter, against the bf16 serving parent
    tok, _, dpr_tree, _ = setup
    tcfg = tdpr.DPRConfig(bert=tbert.BertConfig(**SMALL, add_pooler=False))
    model = convert.params_from_jax(dpr_tree, tcfg, device="cpu")
    fn = tdpr.make_packed_apply(tcfg)
    assert temb.PackedColumnEmbedder(
        fn, model, tok, device="cpu").compute_dtype == torch.float32
    assert temb.PackedTextEmbedder(
        fn, model, tok, device="cpu").compute_dtype == torch.bfloat16


@pytest.mark.parametrize("fixed_rows,pinned", [(8, True), (2, False)],
                         ids=["fits", "overflows"])
def test_fixed_rows_matches_jax(setup, fixed_rows, pinned):
    """A pinned canvas has exactly fixed_rows rows; a batch that overflows
    it is packed on the ROWS_GRANULARITY ladder instead. Same canvas and
    same embeddings as the JAX embedder either way."""
    texts = setup[3][:8]
    ours, ref = _packed_embedders(
        setup, temb.PackedTextEmbedder, jemb.PackedTextEmbedder,
        fixed_rows=fixed_rows)
    p, p_ref = ours.pack(texts), ref.pack(texts)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(p, field),
                                      getattr(p_ref, field), err_msg=field)
    if pinned:
        assert p.rows == fixed_rows
    else:
        assert p.rows == ours.ROWS_GRANULARITY > fixed_rows
    np.testing.assert_allclose(ours(texts)[:8].numpy(),
                               np.asarray(ref(texts))[:8], **TOL)
    ladder, _ = _packed_embedders(setup, temb.PackedTextEmbedder,
                                  jemb.PackedTextEmbedder)
    np.testing.assert_allclose(ours(texts)[:8].numpy(),
                               ladder(texts)[:8].numpy(), **TOL)
    with pytest.raises(ValueError, match="batch_size"):
        ours.pack(setup[3][:9])


def test_dataset_embed_matches_jax(setup, tmp_path):
    from datasets import Dataset, load_from_disk

    texts = setup[3]
    ours, ref = _packed_embedders(
        setup, temb.PackedColumnEmbedder, jemb.PackedColumnEmbedder)
    ds = Dataset.from_dict({"passage": list(texts)})
    a = temb.dataset_embed(ds, ours)
    b = jemb.dataset_embed(ds, ref)
    np.testing.assert_allclose(np.asarray(a["embedding"], np.float32),
                               np.asarray(b["embedding"], np.float32), **TOL)
    # from a path: saved to output_path, or back in place
    ds.save_to_disk(str(tmp_path / "kb"))
    temb.dataset_embed(tmp_path / "kb", ours, output_path=tmp_path / "out")
    out = load_from_disk(str(tmp_path / "out"))
    np.testing.assert_allclose(np.asarray(out["embedding"], np.float32),
                               np.asarray(a["embedding"], np.float32), **TOL)
    temb.dataset_embed(str(tmp_path / "kb"), ours)
    in_place = load_from_disk(str(tmp_path / "kb"))
    assert in_place.column_names == ["passage", "embedding"]
    assert not (tmp_path / "kb.tmp_save").exists()
    assert not (tmp_path / "kb.tmp_old").exists()
    # a swap that a crash left half done is finished first
    (tmp_path / "kb").rename(tmp_path / "kb.tmp_old")
    temb.save_in_place(in_place.remove_columns(["embedding"]),
                       tmp_path / "kb")
    assert load_from_disk(str(tmp_path / "kb")).column_names == ["passage"]
    assert not (tmp_path / "kb.tmp_old").exists()


def test_map_passage_to_kb_and_expand_query_match_jax():
    kb = [{"title": f"T{i}", "image": [i, i + 1],
           "wikipedia_title": f"Entity {i}"} for i in range(6)]
    batch = {"index": [3, 0, 5, 3], "id": ["a", "b", "c", "d"],
             "input": ["who is this", "where", "when", "what"]}
    assert (temb.map_passage_to_kb(batch, kb, ["title", "image"])
            == jemb.map_passage_to_kb(batch, kb, ["title", "image"])
            == {"title": ["T3", "T0", "T5", "T3"],
                "image": [[3, 4], [0, 1], [5, 6], [3, 4]]})
    run = {"a": {"2": 0.5, "4": 0.9}, "b": {}, "d": {"1": -1.0}}
    ours = temb.expand_query(batch, run, kb)
    assert ours == jemb.expand_query(batch, run, kb)
    assert ours == ["who is this Entity 4", "where", "when", "what Entity 1"]
    assert (temb.expand_query(batch, run, kb, reference_key="title")
            == jemb.expand_query(batch, run, kb, reference_key="title"))


def test_embedders_need_a_gpu_unless_cpu_is_named(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    tok, bert_tree, dpr_tree, _ = setup
    tcfg = tbert.BertConfig(**SMALL)
    model = convert.params_from_jax(bert_tree, tcfg, device="cpu")
    with pytest.raises(RuntimeError):
        temb.TextEmbedder(functools.partial(tbert.apply, cfg=tcfg), model,
                          tok)
    with pytest.raises(RuntimeError):
        temb.PackedColumnEmbedder(None, model, tok)
