"""Each trainee's loss with a Mixture-of-Experts encoder against the JAX
trainee's on the same weights and batch: the loss (the task loss plus the
scaled load-balance term), the gradients and the parameters after AdamW
steps (test_torch_trainee.check_parity and its tolerances). Towers: DPR,
ECA and ILF (ICT batches), the BERT re-ranker and the reader, padded and
packed; the MoE layers route top-2 of 2 experts in groups of 16 tokens
with a capacity factor of 2.
"""
import pytest
import torch

from test_torch_moe import MM_BERT, moe_mm_pair
from test_torch_trainee import (check_parity, ict_batch, jtree,  # noqa
                                kb_items, spread, tokenizer)
from viquae_torch.models import bert as tbert
from viquae_torch.models import dpr as tdpr
from viquae_torch.models import qa as tqa
from viquae_torch.models import rr as trr
from viquae_torch.train import data as tdata
from viquae_torch.train import trainee as ttrainee
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.models import qa as jqa
from viquae_tpu.models import rr as jrr
from viquae_tpu.train import trainee as jtrainee

torch.set_num_threads(2)

MOE = dict(moe_experts=2, moe_capacity_factor=2.0, moe_every=1,
           moe_group_size=16)


@pytest.mark.parametrize("packed", [False, True])
def test_moe_biencoder_parity(tokenizer, packed):
    (tq, jq), (tc, jc) = _moe_vocab_pair(0), _moe_vocab_pair(1)
    kb, items = kb_items()
    batch = tdata.BiEncoderCollator(
        tokenizer, kb=kb, M=2, max_length=16, seed=0,
        packed=packed).collate_fn(items)
    check_parity(ttrainee.BiEncoderTrainee(tq, tc),
                 jtrainee.BiEncoderTrainee(jq, jc), batch)


def _moe_vocab_pair(seed):
    """A MoE DPR tower over the trainee tests' 120-token vocabulary."""
    cfg = tdpr.DPRConfig(bert=tbert.BertConfig(**{**MM_BERT, **MOE}))
    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(**{**MM_BERT, **MOE}))
    t = tdpr.DPREncoder(cfg=cfg, params=spread(
        tdpr.init(cfg, seed, device="cpu"), seed))
    return t, jdpr.DPREncoder(cfg=jcfg, params=jtree(t.params))


@pytest.mark.parametrize("kind,packed", [("eca", False), ("eca", True),
                                         ("ilf", True)])
def test_moe_ict_multimodal_parity(tokenizer, kind, packed):
    """ECA / ILF MoE towers through ICT batches, padded and packed."""
    (tq, jq), (tc, jc) = moe_mm_pair(kind, 0, **MOE), \
        moe_mm_pair(kind, 1, **MOE)
    batch = ict_batch(tokenizer, packed, needs_vis=kind == "eca")
    check_parity(ttrainee.BiEncoderTrainee(tq, tc),
                 jtrainee.BiEncoderTrainee(jq, jc), batch)


@pytest.mark.parametrize("packed", [False, True])
def test_moe_reranker_parity(tokenizer, packed):
    bcfg = {**MM_BERT, **MOE}
    tcfg = trr.BertReRankerConfig(bert=tbert.BertConfig(**bcfg))
    jcfg = jrr.BertReRankerConfig(bert=jbert.BertConfig(**bcfg))
    params = spread(trr.bert_reranker_init(tcfg, 0, device="cpu"), 0)

    class TModel:
        def __init__(self):
            self.params = params

        def apply_fn(self, p, **kw):
            return trr.bert_reranker_apply(p, tcfg, **kw)

        def packed_apply_fn(self, p, *args, **kw):
            return trr.bert_reranker_apply_packed(p, tcfg, *args, **kw)

    class JModel:
        def __init__(self):
            self.params = jtree(params)

        def apply_fn(self, p, **kw):
            return jrr.bert_reranker_apply(p, jcfg, **kw)

        def packed_apply_fn(self, p, *args, **kw):
            return jrr.bert_reranker_apply_packed(p, jcfg, *args, **kw)

    kb, items = kb_items(2)
    batch = tdata.ReRankerCollator(
        tokenizer, kb=kb, M=2, max_length=24, seed=0, train=True,
        packed=packed).collate_fn(items)
    check_parity(ttrainee.ReRankerTrainee(TModel(), m_passages=2),
                 jtrainee.ReRankerTrainee(JModel(), m_passages=2), batch)


@pytest.mark.parametrize("packed", [False, True])
def test_moe_reader_parity(tokenizer, packed):
    bcfg = {**MM_BERT, **MOE}
    tcfg = tqa.ReaderConfig(bert=tbert.BertConfig(**bcfg))
    jcfg = jqa.ReaderConfig(bert=jbert.BertConfig(**bcfg))
    params = spread(tqa.init(tcfg, 0, device="cpu"), 0)
    kb, items = kb_items(2)
    batch = tdata.ReaderCollator(
        tokenizer, kb=kb, M=2, max_length=24, max_n_answers=3, seed=0,
        train=True, packed=packed).collate_fn(items)
    check_parity(ttrainee.ReaderTrainee(tcfg, params, tokenizer, 2),
                 jtrainee.ReaderTrainee(jcfg, jtree(params), tokenizer, 2),
                 batch)
