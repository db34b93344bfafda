"""The port's reader (viquae_torch/models/qa.py, train/optim.py) against the
JAX functions on the same weights and inputs, made with numpy from a seed.
Tolerances: 1e-5 on f32 logits, log-probs and losses; 2e-2 on bf16 logits;
span indices and answer strings are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import qa as tqa
from viquae_torch.ops import packing as tpack
from viquae_torch.train import optim as toptim
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import qa as jqa
from viquae_tpu.train import optim as joptim

torch.set_num_threads(2)

SMALL = dict(vocab_size=300, hidden_size=24, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=48,
             max_position_embeddings=64, add_pooler=False)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
M, SEQ = 3, 32


def _configs(fuse):
    return (jqa.ReaderConfig(bert=jbert.BertConfig(**SMALL),
                             fuse_ir_score=fuse),
            tqa.ReaderConfig(bert=tbert.BertConfig(**SMALL),
                             fuse_ir_score=fuse))


def _tree(jcfg, seed=0):
    """JAX-initialised reader params as numpy, every leaf perturbed so that
    biases, LayerNorm scales and the score projection all matter."""
    tree = jax.tree.map(np.asarray, jqa.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(
            np.float32), tree)


def _pairs(seed=0, n=2):
    """(n*M, SEQ) padded pair rows with real lengths 6..SEQ."""
    rng = np.random.default_rng(seed)
    nm = n * M
    lens = rng.integers(6, SEQ + 1, nm)
    ids = np.zeros((nm, SEQ), np.int32)
    mask = np.zeros((nm, SEQ), np.int32)
    tt = np.zeros((nm, SEQ), np.int32)
    for r, ln in enumerate(lens):
        ids[r, :ln] = rng.integers(5, SMALL["vocab_size"], ln)
        mask[r, :ln] = 1
        tt[r, ln // 3: ln] = 1
    scores = rng.normal(size=(nm,)).astype(np.float32) * 3
    return ids, mask, tt, lens, scores


def _packed(ids, tt, lens, pack=tpack):
    seqs = [ids[r, :ln] for r, ln in enumerate(lens)]
    p = pack.pack_token_sequences(seqs, row_len=SEQ, pad_rows_to=4)
    tt_canvas = pack.pack_parallel(p, [tt[r, :ln]
                                       for r, ln in enumerate(lens)])
    g_idx, g_mask = pack.gather_indices(p, SEQ)
    return p, tt_canvas, g_idx, g_mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "fuse_ir"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reader_apply_matches_jax(fuse, dtype):
    jcfg, tcfg = _configs(fuse)
    tree = _tree(jcfg)
    ids, mask, tt, _, scores = _pairs()
    jd, td, tol = ((jnp.float32, torch.float32, F32_TOL) if dtype == "f32"
                   else (jnp.bfloat16, torch.bfloat16, BF16_TOL))
    model = convert.reader_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        out = tqa.reader_apply(
            model, tcfg, _t(ids), attention_mask=_t(mask),
            token_type_ids=_t(tt), m_passages=M, compute_dtype=td,
            passage_scores=_t(scores) if fuse else None)
    ref = jqa.reader_apply(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), token_type_ids=jnp.asarray(tt),
        m_passages=M, compute_dtype=jd,
        passage_scores=jnp.asarray(scores) if fuse else None)
    real = mask == 1
    assert out.start_logits.dtype == torch.float32
    assert out.loss is None and out.start_log_probs is None
    np.testing.assert_allclose(out.start_logits.numpy()[real],
                               np.asarray(ref.start_logits)[real], **tol)
    np.testing.assert_allclose(out.end_logits.numpy()[real],
                               np.asarray(ref.end_logits)[real], **tol)


@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "fuse_ir"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reader_apply_packed_matches_jax(fuse, dtype):
    jcfg, tcfg = _configs(fuse)
    tree = _tree(jcfg, seed=1)
    ids, mask, tt, lens, scores = _pairs(seed=1)
    p, tt_canvas, g_idx, g_mask = _packed(ids, tt, lens)
    jd, td, tol = ((jnp.float32, torch.float32, F32_TOL) if dtype == "f32"
                   else (jnp.bfloat16, torch.bfloat16, BF16_TOL))
    model = convert.reader_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        out = tqa.reader_apply_packed(
            model, tcfg, _t(p.input_ids), _t(p.segment_ids),
            _t(p.position_ids), _t(tt_canvas), _t(g_idx), _t(g_mask),
            m_passages=M, compute_dtype=td,
            passage_scores=_t(scores) if fuse else None)
    ref = jqa.reader_apply_packed(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(p.input_ids),
        jnp.asarray(p.segment_ids), jnp.asarray(p.position_ids),
        jnp.asarray(tt_canvas), jnp.asarray(g_idx), jnp.asarray(g_mask),
        m_passages=M, compute_dtype=jd,
        passage_scores=jnp.asarray(scores) if fuse else None)
    real = mask == 1
    np.testing.assert_array_equal(g_mask, real)
    for ours, theirs in ((out.start_logits, ref.start_logits),
                         (out.end_logits, ref.end_logits)):
        ours, theirs = ours.numpy(), np.asarray(theirs)
        np.testing.assert_allclose(ours[real], theirs[real], **tol)
        # the fill is the same finite value on both sides
        np.testing.assert_array_equal(ours[~real], theirs[~real])
        assert np.isfinite(ours).all()


def test_packed_and_padded_logits_agree_on_real_tokens():
    """Within the port: the packed canvas gives the padded path's logits
    on every real token (f32, 1e-5)."""
    _, tcfg = _configs(True)
    jcfg, _ = _configs(True)
    model = convert.reader_from_jax(_tree(jcfg, seed=2), tcfg, device="cpu")
    ids, mask, tt, lens, scores = _pairs(seed=2)
    p, tt_canvas, g_idx, g_mask = _packed(ids, tt, lens)
    with torch.no_grad():
        padded = tqa.reader_apply(model, tcfg, _t(ids),
                                  attention_mask=_t(mask),
                                  token_type_ids=_t(tt), m_passages=M,
                                  passage_scores=_t(scores))
        packed = tqa.reader_apply_packed(
            model, tcfg, _t(p.input_ids), _t(p.segment_ids),
            _t(p.position_ids), _t(tt_canvas), _t(g_idx), _t(g_mask),
            m_passages=M, passage_scores=_t(scores))
    real = mask == 1
    np.testing.assert_allclose(packed.start_logits.numpy()[real],
                               padded.start_logits.numpy()[real], **F32_TOL)
    np.testing.assert_allclose(packed.end_logits.numpy()[real],
                               padded.end_logits.numpy()[real], **F32_TOL)


def test_all_padding_pair_rows_stay_finite():
    """An empty passage keeps its row all-zero (attention_mask 0
    everywhere): the finite additive bias gives uniform attention, so the
    logits are finite and equal the JAX ones."""
    jcfg, tcfg = _configs(False)
    tree = _tree(jcfg, seed=3)
    ids, mask, tt, _, _ = _pairs(seed=3)
    ids[1] = 0
    mask[1] = 0
    tt[1] = 0
    model = convert.reader_from_jax(tree, tcfg, device="cpu")
    for td, jd, tol in ((torch.float32, jnp.float32, F32_TOL),
                        (torch.bfloat16, jnp.bfloat16, BF16_TOL)):
        with torch.no_grad():
            out = tqa.reader_apply(model, tcfg, _t(ids),
                                   attention_mask=_t(mask),
                                   token_type_ids=_t(tt), m_passages=M,
                                   compute_dtype=td)
        ref = jqa.reader_apply(
            jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(ids),
            attention_mask=jnp.asarray(mask),
            token_type_ids=jnp.asarray(tt), m_passages=M, compute_dtype=jd)
        assert torch.isfinite(out.start_logits).all()
        assert torch.isfinite(out.end_logits).all()
        np.testing.assert_allclose(out.start_logits.numpy()[1],
                                   np.asarray(ref.start_logits)[1], **tol)


def _loss_inputs(seed, n=3, m=M, length=16, a=4):
    rng = np.random.default_rng(seed)
    nm = n * m
    start_logits = rng.normal(size=(nm, length)).astype(np.float32) * 2
    end_logits = rng.normal(size=(nm, length)).astype(np.float32) * 2
    # positions past the sequence (and -1) are the ignored index
    start = rng.integers(-1, length + 3, (nm, a)).astype(np.int32)
    end = rng.integers(-1, length + 3, (nm, a)).astype(np.int32)
    answer_mask = (rng.random((nm, a)) > 0.4).astype(np.int32)
    answer_mask[0] = 0  # a row with no answer at all
    return start_logits, end_logits, start, end, answer_mask


@pytest.mark.parametrize("max_pooling", [False, True],
                         ids=["mean", "max_pooling"])
@pytest.mark.parametrize("seed", [0, 1])
def test_multi_passage_rc_loss_matches_jax(max_pooling, seed):
    args = _loss_inputs(seed)
    loss, slp, elp = toptim.multi_passage_rc_loss(
        *(_t(a) for a in args), m_passages=M, max_pooling=max_pooling)
    ref_loss, ref_slp, ref_elp = joptim.multi_passage_rc_loss(
        *(jnp.asarray(a) for a in args), m_passages=M,
        max_pooling=max_pooling)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), **F32_TOL)
    np.testing.assert_allclose(slp.numpy(), np.asarray(ref_slp), **F32_TOL)
    np.testing.assert_allclose(elp.numpy(), np.asarray(ref_elp), **F32_TOL)


def test_multi_passage_rc_loss_gradient_matches_jax():
    """Autograd through the plain function gives the JAX gradient."""
    args = _loss_inputs(5)
    s = _t(args[0]).requires_grad_(True)
    e = _t(args[1]).requires_grad_(True)
    loss, _, _ = toptim.multi_passage_rc_loss(
        s, e, *(_t(a) for a in args[2:]), m_passages=M)
    loss.backward()

    def f(sl, el):
        return joptim.multi_passage_rc_loss(
            sl, el, *(jnp.asarray(a) for a in args[2:]), m_passages=M)[0]

    gs, ge = jax.grad(f, argnums=(0, 1))(jnp.asarray(args[0]),
                                         jnp.asarray(args[1]))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), **F32_TOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), **F32_TOL)


def test_reader_apply_with_positions_returns_jax_loss():
    jcfg, tcfg = _configs(False)
    tree = _tree(jcfg, seed=4)
    ids, mask, tt, _, _ = _pairs(seed=4)
    rng = np.random.default_rng(4)
    nm = len(ids)
    start = rng.integers(0, SEQ, (nm, 2)).astype(np.int32)
    end = np.minimum(start + rng.integers(0, 3, (nm, 2)), SEQ).astype(
        np.int32)
    amask = (rng.random((nm, 2)) > 0.3).astype(np.int32)
    model = convert.reader_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        out = tqa.reader_apply(
            model, tcfg, _t(ids), attention_mask=_t(mask),
            token_type_ids=_t(tt), m_passages=M,
            start_positions=_t(start).reshape(-1, M, 2),
            end_positions=_t(end).reshape(-1, M, 2),
            answer_mask=_t(amask).reshape(-1, M, 2))
    ref = jqa.reader_apply(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), token_type_ids=jnp.asarray(tt),
        m_passages=M, start_positions=jnp.asarray(start),
        end_positions=jnp.asarray(end), answer_mask=jnp.asarray(amask))
    np.testing.assert_allclose(out.loss.numpy(), np.asarray(ref.loss),
                               **F32_TOL)
    np.testing.assert_allclose(out.start_log_probs.numpy(),
                               np.asarray(ref.start_log_probs), **F32_TOL)
    np.testing.assert_allclose(out.end_log_probs.numpy(),
                               np.asarray(ref.end_log_probs), **F32_TOL)


def _probs(seed, n=4, m=M, length=12):
    rng = np.random.default_rng(seed)
    s = rng.random((n, m, length)).astype(np.float32)
    e = rng.random((n, m, length)).astype(np.float32)
    return s / s.sum((1, 2), keepdims=True), e / e.sum((1, 2), keepdims=True)


def _spans_equal(s, e, weights=None, **kw):
    ours = tqa.get_best_spans(
        _t(s), _t(e), weights=None if weights is None else _t(weights), **kw)
    ref = jqa.get_best_spans(
        jnp.asarray(s), jnp.asarray(e),
        weights=None if weights is None else jnp.asarray(weights), **kw)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return tuple(a.numpy() for a in ours)


@pytest.mark.parametrize("case", ["random", "weights_over_1",
                                  "weights_under_1", "first_token_allowed"])
def test_get_best_spans_matches_jax(case):
    for seed in range(3):
        s, e = _probs(seed)
        rng = np.random.default_rng(seed + 10)
        if case == "random":
            passage, start, end = _spans_equal(s, e)
            assert (start >= 1).all() and (end > start).all()
        elif case == "weights_over_1":
            _spans_equal(s, e, 1 + rng.random(s.shape[:2]).astype(
                np.float32) * 5)
        elif case == "weights_under_1":
            # a minimum under 1 shifts every weight by 1 - min
            _spans_equal(s, e, rng.normal(size=s.shape[:2]).astype(
                np.float32) * 4)
        else:
            s[:, :, 0] += 1.0  # the [CLS] position now wins when allowed
            _, start, _ = _spans_equal(s, e, cannot_be_first_token=False)
            assert (start == 0).all()
            _, start, _ = _spans_equal(s, e)
            assert (start >= 1).all()


def test_get_best_spans_exact_ties_go_to_the_first_maximum():
    """Equal probabilities in two passages and in two spans of a passage:
    both packages pick the lowest passage, then the lowest flat span."""
    n, m, length = 2, 3, 8
    s = np.zeros((n, m, length), np.float32)
    e = np.zeros((n, m, length), np.float32)
    # question 0: passages 1 and 2 hold the same best span
    s[0, 1, 2] = s[0, 2, 2] = 0.5
    e[0, 1, 4] = e[0, 2, 4] = 0.5
    # question 1: one passage, starts 2 and 3 and ends 4 and 5 all tie
    s[1, 2, 2] = s[1, 2, 3] = 0.25
    e[1, 2, 5] = e[1, 2, 4] = 0.25
    passage, start, end = _spans_equal(s, e)
    assert passage.tolist() == [1, 2]
    assert start.tolist() == [2, 2]
    assert end.tolist() == [5, 5]   # end index 4, exclusive
    # uniform rows (an all-masked question): every entry ties
    u = np.full((1, m, length), 1.0 / (m * length), np.float32)
    passage, start, end = _spans_equal(u, u)
    assert (passage.tolist(), start.tolist(), end.tolist()) == ([0], [1], [2])


def test_log_probs_to_answers_matches_jax(tmp_path):
    from transformers import BertTokenizerFast

    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"w{i}" for i in range(200)])
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt"))
    rng = np.random.default_rng(0)
    n, length = 3, 16
    ids = rng.integers(2, 205, (n * M, length)).astype(np.int32)
    slp = np.log(rng.random((n * M, length)).astype(np.float32) + 1e-3)
    elp = np.log(rng.random((n * M, length)).astype(np.float32) + 1e-3)
    weights = 1 + rng.random((n, M)).astype(np.float32)
    for w in (None, weights):
        ours = tqa.log_probs_to_answers(_t(slp), _t(elp), _t(ids), tok, M,
                                        weights=w)
        ref = jqa.log_probs_to_answers(slp, elp, ids, tok, M, weights=w)
        assert ours == ref
        assert all(isinstance(a, str) for a in ours)
    # numpy inputs are accepted as well
    assert tqa.log_probs_to_answers(slp, elp, ids, tok, M) == \
        jqa.log_probs_to_answers(slp, elp, ids, tok, M)


@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "fuse_ir"])
def test_reader_from_jax_layout(fuse):
    jcfg, tcfg = _configs(fuse)
    tree = _tree(jcfg, seed=6)
    model = convert.reader_from_jax(tree, tcfg, device="cpu")
    np.testing.assert_array_equal(model.qa_outputs.weight.numpy(),
                                  tree["qa_outputs"]["kernel"].T)
    np.testing.assert_array_equal(model.qa_outputs.bias.numpy(),
                                  tree["qa_outputs"]["bias"])
    np.testing.assert_array_equal(
        model.bert.embeddings["word"].weight.numpy(),
        tree["bert"]["embeddings"]["word"])
    assert model.bert.pooler is None
    assert not any(p.requires_grad for p in model.parameters())
    assert hasattr(model, "score_proj_w") == fuse
    if fuse:
        np.testing.assert_array_equal(model.score_proj_w.numpy(),
                                      tree["score_proj_w"])
        assert model.score_proj_b.shape == (1,)
    m16 = convert.reader_from_jax(tree, tcfg, device="cpu",
                                  dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in m16.parameters())
    # init_reader_tree draws the JAX layout: same structure and shapes,
    # the same tree for the same seed, identity score projection
    ours = convert.init_reader_tree(tcfg, seed=3)
    ref = jax.tree.map(np.asarray, jqa.init(jax.random.key(0), jcfg))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == np.float32
    again = convert.init_reader_tree(tcfg, seed=3)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    if fuse:
        assert ours["score_proj_w"].tolist() == [[1.0]]
        assert ours["score_proj_b"].tolist() == [0.0]


def test_reader_entry_points_need_a_gpu_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    jcfg, tcfg = _configs(False)
    with pytest.raises(RuntimeError):
        convert.reader_from_jax(_tree(jcfg), tcfg)
    with pytest.raises(RuntimeError):
        tqa.MultiPassageBERTReader(cfg=tcfg)


def test_registry_bundle():
    from viquae_torch.core import config as tconfig

    cls = tconfig.get_class_from_name("MultiPassageBERTReader")
    assert cls is tqa.MultiPassageBERTReader
    bundle = cls(bert_config={k: v for k, v in SMALL.items()
                              if k != "add_pooler"},
                 fuse_ir_score=True, seed=2, device="cpu")
    assert bundle.cfg.fuse_ir_score and not bundle.cfg.bert.add_pooler
    assert isinstance(bundle.params, tqa.Reader)
    assert bundle.params.score_proj_w.tolist() == [[1.0]]
    with pytest.raises(NotImplementedError, match="A16"):
        cls.from_pretrained("somewhere")


# --------------------------------------------------------------------------
# HF checkpoints: a tiny BertForQuestionAnswering saved with save_pretrained
# --------------------------------------------------------------------------
TINY = dict(vocab_size=1100, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)


@pytest.fixture(scope="module")
def reader_ckpt_dir(tmp_path_factory):
    from transformers import BertConfig, BertForQuestionAnswering

    torch.manual_seed(7)
    model = BertForQuestionAnswering(BertConfig(**TINY)).eval()
    root = tmp_path_factory.mktemp("reader_ckpt")
    model.save_pretrained(root)
    return root, model


def _assert_reader_equals_tree(model, tree):
    """Every weight of the port's Reader equals the JAX tree's leaf."""
    ref = convert.reader_from_jax(jax.tree.map(np.asarray, tree), model.cfg,
                                  device="cpu")
    ours, theirs = model.state_dict(), ref.state_dict()
    assert ours.keys() == theirs.keys()
    for name in ours:
        np.testing.assert_array_equal(ours[name].numpy(),
                                      theirs[name].numpy(), err_msg=name)


def test_params_from_pretrained_dir_matches_jax(reader_ckpt_dir):
    path, hf_model = reader_ckpt_dir
    model, cfg = tqa.params_from_pretrained_dir(path, device="cpu")
    tree, jcfg = jqa.params_from_pretrained_dir(path)
    assert cfg.bert.hidden_size == jcfg.bert.hidden_size == 32
    assert cfg.bert.num_hidden_layers == jcfg.bert.num_hidden_layers
    assert cfg.bert.layer_norm_eps == jcfg.bert.layer_norm_eps
    assert not cfg.fuse_ir_score and not cfg.bert.add_pooler
    _assert_reader_equals_tree(model, tree)
    # and the forward agrees with the HF model itself
    rng = np.random.default_rng(0)
    n, length = 2, 16
    ids = rng.integers(5, TINY["vocab_size"], (n * M, length))
    mask = (rng.random((n * M, length)) > 0.2).astype(np.int64)
    mask[:, 0] = 1
    with torch.no_grad():
        ref = hf_model(input_ids=torch.tensor(ids),
                       attention_mask=torch.tensor(mask))
        out = tqa.reader_apply(model, cfg, torch.tensor(ids),
                               attention_mask=torch.tensor(mask),
                               m_passages=M)
    np.testing.assert_allclose(out.start_logits.numpy()[mask == 1],
                               ref.start_logits.numpy()[mask == 1],
                               atol=2e-5)
    np.testing.assert_allclose(out.end_logits.numpy()[mask == 1],
                               ref.end_logits.numpy()[mask == 1], atol=2e-5)


@pytest.mark.parametrize("with_proj", [True, False],
                         ids=["proj_in_file", "proj_seeded"])
def test_params_from_hf_fused_matches_jax(reader_ckpt_dir, tmp_path,
                                          with_proj):
    path, hf_model = reader_ckpt_dir
    sd = dict(hf_model.state_dict())
    if with_proj:
        sd["score_proj_w"] = torch.full((1, 1), 2.5)
        sd["score_proj_b"] = torch.full((1,), -0.5)
    hf_model.config.save_pretrained(tmp_path)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    tcfg = tqa.ReaderConfig(
        bert=tbert.BertConfig.from_hf(hf_model.config, add_pooler=False),
        fuse_ir_score=True)
    jcfg = jqa.ReaderConfig(
        bert=jbert.BertConfig.from_hf(hf_model.config, add_pooler=False),
        fuse_ir_score=True)
    model, cfg2 = tqa.params_from_pretrained_dir(tmp_path, tcfg,
                                                 device="cpu")
    assert cfg2 is tcfg
    tree, _ = jqa.params_from_pretrained_dir(tmp_path, jcfg)
    if with_proj:
        assert float(model.score_proj_w[0, 0]) == 2.5
        assert float(model.score_proj_b[0]) == -0.5
    else:
        # absent from the file: the identity projection is seeded (the JAX
        # function leaves that to its caller)
        assert "score_proj_w" not in tree
        assert float(model.score_proj_w[0, 0]) == 1.0
        assert float(model.score_proj_b[0]) == 0.0
        tree = {**tree, "score_proj_w": np.ones((1, 1), np.float32),
                "score_proj_b": np.zeros((1,), np.float32)}
    _assert_reader_equals_tree(model, tree)
    # a wrapper prefix is stripped as in the JAX function
    prefixed = {f"model.{k}": v for k, v in sd.items()}
    again = tqa.params_from_hf(prefixed, tcfg, prefix="model.", device="cpu")
    _assert_reader_equals_tree(again, tree)


def test_params_from_pretrained_dir_reads_safetensors(reader_ckpt_dir,
                                                      tmp_path):
    from safetensors.torch import save_file

    path, hf_model = reader_ckpt_dir
    hf_model.config.save_pretrained(tmp_path)
    save_file({k: v.contiguous() for k, v in hf_model.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    model, _ = tqa.params_from_pretrained_dir(tmp_path, device="cpu")
    tree, _ = jqa.params_from_pretrained_dir(tmp_path)
    _assert_reader_equals_tree(model, tree)
