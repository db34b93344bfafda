"""The online image and face legs of late fusion on the CPU: ImageEmbedder
and FaceDetector against the JAX package's, MultiIndexRetrievalPipeline
with online image + face legs against the JAX pipeline on the same tiny
towers (gzmuv and raw), the online legs against the same features passed
precomputed, and BatchedVQAService over HTTP.

Tolerances: embeddings within 1e-4 of their scale; fused rankings (bf16
wire scores): ids equal on >= 97 % of positions (f32 towers on the two
sides differ in the last bits, which can swap near-tied KB rows) and,
where the ids agree, scores within one bf16 ulp or 1e-3 of the largest
score (the face leg's embeddings carry the ~1e-4 that alignment's f32
rounding leaves, tests/test_torch_face.py, and a fused score near 0 has
bf16 ulps far below that)."""
import base64
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import bf16_ulp_distance, jax_tree
from viquae_torch.image.embedding import ImageEmbedder as TImageEmbedder
from viquae_torch.image.face_recognition import FaceQueryEncoder as TFaceEnc
from viquae_torch.ir.embedding import PackedTextEmbedder as TEmbedder
from viquae_torch.ir.serving import MultiIndexRetrievalPipeline as TMulti
from viquae_torch.models import arcface as tarc
from viquae_torch.models import bert as tbert
from viquae_torch.models import clip as tclip
from viquae_torch.models import convert
from viquae_torch.models import dpr as tdpr
from viquae_torch.models import mtcnn as tmt
from viquae_torch.models import resnet as tres
from viquae_torch.ops import mips as tm
from viquae_tpu.models import arcface as jarc
from viquae_tpu.models import clip as jclip
from viquae_tpu.models import mtcnn as jmt
from viquae_tpu.models import resnet as jres

torch.set_num_threads(2)

SMALL = dict(vocab_size=300, hidden_size=24, num_hidden_layers=1,
             num_attention_heads=2, intermediate_size=48,
             max_position_embeddings=64, add_pooler=False)
RES_CFG = jres.ResNetConfig(stage_sizes=(1, 1), width=8)          # 64-d
VIT_CFG = jclip.CLIPVisionConfig(hidden_size=32, num_layers=1, num_heads=4,
                                 intermediate_size=64, image_size=32,
                                 patch_size=8, projection_dim=16)
MT_CFG = jmt.MTCNNConfig(canvas=64, min_face_size=20,
                         thresholds=(0.5, 0.5, 0.5))
ARC_CFG = jarc.ArcFaceConfig(stage_sizes=(1, 1, 1, 1), width=8,
                             embedding_size=16)
N_Q, BATCH, K = 16, 8, 6
WEIGHTS = {"dpr": 0.4, "img": 0.2, "clip": 0.2, "face": 0.2}


def _image(rng, h, w, mode="RGB"):
    from PIL import Image

    return Image.fromarray(
        rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).convert(mode)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from transformers import BertTokenizerFast

    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"w{i}" for i in range(200)])
    d = tmp_path_factory.mktemp("imgtok")
    (d / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(d / "vocab.txt"))
    rng = np.random.default_rng(0)
    queries = [" ".join(f"w{j}" for j in rng.integers(0, 200, 6))
               for _ in range(N_Q)]
    # every 5th query has no image; sizes below, at and above the
    # detection canvas (the face leg's redo path), one grayscale
    sizes = [(48, 40), (64, 64), (96, 72), (40, 56), (80, 120)]
    images = [None if i % 5 == 4 else _image(
        rng, *sizes[i % 5], mode="L" if i == 7 else "RGB")
        for i in range(N_Q)]
    n_kb = 40
    kb = {"dpr": rng.normal(size=(n_kb, 24)), "img": rng.normal(
        size=(n_kb, 64)), "clip": rng.normal(size=(n_kb, 16)),
        "face": rng.normal(size=(n_kb, 16))}
    trees = {
        "dpr": convert.init_tree(tdpr.DPRConfig(bert=tbert.BertConfig(
            **SMALL)), seed=0),
        "img": jax_tree(tres.init(RES_CFG, seed=1, device="cpu")),
        "clip": jax_tree(tclip.vit_init(VIT_CFG, seed=2, device="cpu")),
        "mtcnn": jax_tree(tmt.init(seed=3, device="cpu")),
        "arcface": jax_tree(tarc.init(ARC_CFG, seed=4, device="cpu")),
    }
    return dict(tok=tok, queries=queries, images=images, kb=kb, trees=trees)


def _port_parts(w, batch=BATCH):
    cfg = tdpr.DPRConfig(bert=tbert.BertConfig(**SMALL))
    emb = TEmbedder(tdpr.make_packed_apply(cfg), convert.params_from_jax(
        w["trees"]["dpr"], cfg, device="cpu"), w["tok"], row_len=16,
        batch_size=batch, compute_dtype=torch.float32, device="cpu")
    img = TImageEmbedder(
        lambda p, x: tres.apply(p, RES_CFG, x),
        tres.from_jax(w["trees"]["img"], RES_CFG, device="cpu"), "img",
        image_size=32, preprocessing="imagenet", batch_size=4,
        device="cpu")
    clip = TImageEmbedder(
        lambda p, x: tclip.vit_apply(p, VIT_CFG, x)["image_embeds"],
        tclip.vit_from_jax(w["trees"]["clip"], VIT_CFG, device="cpu"),
        "clip", image_size=32, preprocessing="clip", batch_size=4,
        device="cpu")
    face = TFaceEnc(tmt.from_jax(w["trees"]["mtcnn"], device="cpu"),
                    tarc.from_jax(w["trees"]["arcface"], ARC_CFG,
                                  device="cpu"),
                    mtcnn_cfg=MT_CFG, arcface_cfg=ARC_CFG, batch_size=4,
                    device="cpu")
    indexes = {n: tm.DenseIndex(a, mode="global", do_l2norm=n != "dpr",
                                device="cpu") for n, a in w["kb"].items()}
    return emb, {"img": img, "clip": clip}, {"face": face}, indexes


def _jax_parts(w):
    from viquae_tpu.image.embedding import ImageEmbedder as JImageEmbedder
    from viquae_tpu.image.face_recognition import FaceQueryEncoder
    from viquae_tpu.ir.embedding import PackedTextEmbedder as JEmbedder
    from viquae_tpu.models import bert as jbert
    from viquae_tpu.models import dpr as jdpr
    from viquae_tpu.ops import mips as jm

    def jt(name):
        return jax.tree.map(jnp.asarray, w["trees"][name])

    cfg = jdpr.DPRConfig(bert=jbert.BertConfig(**SMALL))
    emb = JEmbedder(jdpr.make_packed_apply(cfg), jt("dpr"), w["tok"],
                    row_len=16, batch_size=BATCH, compute_dtype=jnp.float32)
    img = JImageEmbedder(lambda p, x: jres.apply(p, RES_CFG, x), jt("img"),
                         "img", image_size=32, preprocessing="imagenet",
                         batch_size=4)
    clip = JImageEmbedder(
        lambda p, x: jclip.vit_apply(p, VIT_CFG, x)["image_embeds"],
        jt("clip"), "clip", image_size=32, preprocessing="clip",
        batch_size=4)
    face = FaceQueryEncoder(jt("mtcnn"), jt("arcface"), mtcnn_cfg=MT_CFG,
                            arcface_cfg=ARC_CFG, batch_size=4)
    indexes = {n: jm.DenseIndex(a, mode="global", do_l2norm=n != "dpr")
               for n, a in w["kb"].items()}
    return emb, {"img": img, "clip": clip}, {"face": face}, indexes


@pytest.fixture(scope="module")
def jax_parts(world):
    """One set of JAX encoders for the module: their jitted forwards
    compile once."""
    return _jax_parts(world)


def _close(got, ref, rel=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert np.abs(got[ok] - ref[ok]).max() <= rel * np.abs(ref[ok]).max()


def _assert_close_rankings(idx, ref_i, scores, ref_s, min_agree=0.97):
    assert np.mean(idx == ref_i) >= min_agree, np.mean(idx == ref_i)
    same = idx == ref_i
    near = np.abs(scores - ref_s) <= 1e-3 * np.abs(ref_s).max()
    assert ((bf16_ulp_distance(scores, ref_s) <= 1) | near)[same].all()


# --------------------------------------------------------------------------
# ImageEmbedder, FaceDetector
# --------------------------------------------------------------------------
@pytest.mark.parametrize("leg", ["img", "clip"])
def test_image_embedder_matches_jax(world, jax_parts, leg):
    """None rows NaN, a grayscale image converted, every other row within
    1e-4 of the JAX embedder's (host PIL resize + device preprocess +
    tower)."""
    ours = _port_parts(world)[1][leg].embed_images(world["images"])
    ref = jax_parts[1][leg].embed_images(world["images"])
    assert ours.dtype == np.float32
    assert np.isnan(ours[4]).all() and np.isfinite(ours[7]).all()
    _close(ours, ref)


def test_image_embedder_all_none_probes_the_width(world):
    enc = _port_parts(world)[1]["img"]
    out = enc.embed_images([None] * 5)
    assert out.shape == (5, 64) and np.isnan(out).all()


def test_face_detector_matches_jax_with_padded_final_chunk(world):
    """6 present images at batch 4: the final chunk is padded with zero
    canvases; None and too-small images keep None; probabilities within
    1e-4, boxes and landmarks (scaled back to the original images) within
    2e-2 px."""
    from viquae_torch.image.face_detection import FaceDetector as TDet
    from viquae_tpu.image.face_detection import FaceDetector as JDet

    rng = np.random.default_rng(5)
    images = [_image(rng, 64, 64), None, _image(rng, 96, 72),
              _image(rng, 10, 30), _image(rng, 50, 40, mode="L"),
              _image(rng, 64, 48), _image(rng, 40, 64), _image(rng, 64, 64)]
    ours = TDet(tmt.from_jax(world["trees"]["mtcnn"], device="cpu"),
                cfg=MT_CFG, batch_size=4, device="cpu")
    ref = JDet(jax.tree.map(jnp.asarray, world["trees"]["mtcnn"]),
               cfg=MT_CFG, batch_size=4)
    probs, boxes, lms = ours.detect_batch(images)
    r_probs, r_boxes, r_lms = ref.detect_batch(images)
    assert probs[1] is None and probs[3] is None
    assert sum(p is not None for p in probs) >= 4
    for i in range(len(images)):
        assert (probs[i] is None) == (r_probs[i] is None), i
        if r_probs[i] is None:
            continue
        np.testing.assert_allclose(probs[i], r_probs[i], atol=1e-4)
        np.testing.assert_allclose(boxes[i], r_boxes[i], atol=2e-2)
        np.testing.assert_allclose(lms[i], r_lms[i], atol=2e-2)


# --------------------------------------------------------------------------
# MultiIndexRetrievalPipeline with online legs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("norm", ["gzmuv", "raw"])
def test_online_legs_match_the_jax_pipeline(world, jax_parts, norm):
    """DPR + ResNet (imagenet) + CLIP ViT + MTCNN -> ArcFace, all online,
    two batches, against the JAX pipeline with the same encoders. No
    image is at a leg's input size: every leg resizes on the host."""
    from viquae_tpu.ir.serving import MultiIndexRetrievalPipeline as JMulti

    assert all(im is None or im.size != (32, 32) for im in world["images"])
    query_images = {n: world["images"] for n in ("img", "clip", "face")}
    outs = []
    for pipe_cls, parts in ((TMulti, _port_parts(world)),
                            (JMulti, jax_parts)):
        emb, images, faces, indexes = parts
        pipe = pipe_cls(emb, indexes, WEIGHTS, "dpr", batch_size=BATCH, k=K,
                        norm=norm, compact_transfer=False,
                        image_encoders=images, face_encoders=faces)
        outs.append(pipe.run_arrays(world["queries"],
                                    query_images=query_images))
    (scores, idx), (ref_s, ref_i) = outs
    assert scores.shape == (N_Q, K) and np.isfinite(scores).all()
    _assert_close_rankings(idx, ref_i, scores, ref_s)


def _online_image_features(enc, images):
    """An image leg's features as the online leg computes them: the
    serving decode, then preprocess + tower. (embed_images resizes the
    imagenet kind with another PIL filter, ROADMAP.md C5.)"""
    from viquae_torch.image.embedding import decode_image_batch

    canvas, ok = decode_image_batch(images, enc.raw_size, len(images))
    out = enc._forward(enc.params, torch.from_numpy(canvas)).numpy()
    out[~ok] = np.nan
    return out


def test_online_legs_equal_precomputed_features(world):
    """The online legs give what the same encoders' features give when
    passed precomputed: the image legs' decode + preprocess + tower and
    FaceQueryEncoder called directly on the same images (NaN rows = absent
    from that leg), both without compact transfer (the image legs'
    embeddings stay f32)."""
    emb, images, faces, indexes = _port_parts(world)
    feats = {n: _online_image_features(e, world["images"])
             for n, e in images.items()}
    # the clip kind's embed_images resizes as the serving decode does
    _close(images["clip"].embed_images(world["images"]), feats["clip"],
           rel=1e-6)
    feats["face"] = faces["face"](world["images"])
    assert np.isnan(feats["face"][4]).all()
    assert np.isfinite(feats["face"]).all(axis=1).sum() >= 6
    query_images = {n: world["images"] for n in ("img", "clip", "face")}
    online = TMulti(emb, indexes, WEIGHTS, "dpr", batch_size=BATCH, k=K,
                    compact_transfer=False, image_encoders=images,
                    face_encoders=faces)
    staged = TMulti(emb, indexes, WEIGHTS, "dpr", batch_size=BATCH, k=K,
                    compact_transfer=False)
    s_on, i_on = online.run_arrays(world["queries"],
                                   query_images=query_images)
    s_st, i_st = staged.run_arrays(world["queries"], feats)
    np.testing.assert_array_equal(i_on, i_st)
    np.testing.assert_allclose(s_on, s_st, rtol=1e-6, atol=0)
    run = online.run([str(i) for i in range(N_Q)], world["queries"],
                     query_images=query_images)
    assert run.name == "serving-fusion" and len(run) == N_Q
    device_out = online.run_device(world["queries"],
                                   query_images=query_images)
    assert [start for start, _, _ in device_out] == [0, BATCH]
    np.testing.assert_array_equal(device_out[1][2][: N_Q - BATCH].numpy(),
                                  i_on[BATCH:])


@pytest.mark.parametrize("leg", ["img", "clip"])
def test_online_legs_decode_like_the_jax_package(world, leg):
    """The serving decode's canvas is the JAX package's, bit for bit, on
    every leg (PIL's default filter, whatever the preprocessing kind)."""
    from viquae_torch.image.embedding import decode_image_batch
    from viquae_tpu.image.embedding import \
        decode_image_batch as jax_decode

    enc = _port_parts(world)[1][leg]
    canvas, ok = decode_image_batch(world["images"], enc.raw_size, N_Q + 2)
    ref, ref_ok = jax_decode(world["images"], enc.raw_size, N_Q + 2)
    np.testing.assert_array_equal(canvas, ref)
    np.testing.assert_array_equal(ok, ref_ok)
    assert ok.sum() == 13 and not ok[N_Q:].any()


def test_online_leg_validation(world):
    emb, images, faces, indexes = _port_parts(world)
    with pytest.raises(ValueError, match="image_encoders"):
        TMulti(emb, indexes, WEIGHTS, "dpr", image_encoders={"dpr": 1})
    with pytest.raises(ValueError, match="image_encoders"):
        TMulti(emb, indexes, WEIGHTS, "dpr", image_encoders={"nope": 1})
    with pytest.raises(ValueError, match="face_encoders"):
        TMulti(emb, indexes, WEIGHTS, "dpr", face_encoders={"dpr": 1})
    with pytest.raises(ValueError, match="face_encoders"):
        TMulti(emb, indexes, WEIGHTS, "dpr", image_encoders=images,
               face_encoders={"img": 1})
    pipe = TMulti(emb, indexes, WEIGHTS, "dpr", batch_size=BATCH, k=K,
                  image_encoders=images, face_encoders=faces)
    q = world["queries"][:3]
    with pytest.raises(ValueError, match="query_images keys"):
        pipe.run_arrays(q, query_images={"img": [None] * 3})
    with pytest.raises(ValueError, match="entries for"):
        pipe.run_arrays(q, query_images={"img": [None] * 3,
                                         "clip": [None] * 2,
                                         "face": [None] * 3})
    # no image anywhere: every modal leg absent, the text leg decides
    scores, idx = pipe.run_arrays(q, query_images={
        n: [None] * 3 for n in ("img", "clip", "face")})
    assert np.isfinite(scores).all() and idx.shape == (3, K)


# --------------------------------------------------------------------------
# the VQA service over HTTP
# --------------------------------------------------------------------------
class _Recorded:
    def __init__(self, pipe):
        self.pipe, self.calls = pipe, []

    def run(self, questions, **kwargs):
        self.calls.append((list(questions), kwargs))
        return self.pipe.run(questions, **kwargs)


def _png_b64(image):
    buf = io.BytesIO()
    image.convert("RGB").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_vqa_service_over_http_equals_the_direct_call(world):
    """BatchedVQAService over an AnswerPipeline whose retrieval has online
    image and face legs: /answer with image_b64 (every leg), images_b64
    (one leg) and no image; each response equals the direct pipeline call
    on the batch it was dispatched in."""
    from viquae_torch.ir.qa_serving import AnswerPipeline
    from viquae_torch.ir.server import BatchedVQAService, make_http_server
    from viquae_torch.models import qa as tqa

    emb, images, faces, indexes = _port_parts(world, batch=4)
    retrieval = TMulti(emb, indexes, WEIGHTS, "dpr", batch_size=4, k=K,
                       image_encoders=images, face_encoders=faces)
    rcfg = tqa.ReaderConfig(bert=tbert.BertConfig(**SMALL))
    reader = convert.reader_from_jax(convert.init_reader_tree(rcfg, seed=5),
                                     rcfg, device="cpu")
    rng = np.random.default_rng(6)
    kb_rows = [{"passage": " ".join(f"w{j}" for j in rng.integers(0, 200, 10))}
               for _ in range(40)]
    answers = AnswerPipeline(retrieval, kb_rows, rcfg, reader, world["tok"],
                             m_passages=3, reader_seq=48,
                             questions_per_step=4, device="cpu")
    recorded = _Recorded(answers)
    names = ["img", "clip", "face"]
    service = BatchedVQAService(recorded, names, max_batch=4,
                                max_wait_ms=50.0)
    server = make_http_server("127.0.0.1", 0, vqa=service)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/answer"
    try:
        pics = [world["images"][i] for i in (0, 2, 3)]
        payloads = [
            {"question": world["queries"][0], "image_b64": _png_b64(pics[0])},
            {"question": world["queries"][1],
             "images_b64": {"face": _png_b64(pics[1])}},
            {"question": world["queries"][2]},
            {"question": world["queries"][3], "image_b64": _png_b64(pics[2])},
        ]
        results = [None] * len(payloads)

        def send(j):
            results[j] = _post(url, payloads[j])

        threads = [threading.Thread(target=send, args=(j,))
                   for j in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(r is not None and r[0] == 200 for r in results), results
        status, bad = 400, None
        try:
            _post(url, {"question": "w1", "image_b64": "AAAA"})
        except urllib.error.HTTPError as e:
            bad = e.code
        assert bad == status
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
        service.close()
    expected = {}
    for questions, kwargs in recorded.calls:
        assert len(questions) == 4
        for q, out in zip(questions, answers.run(questions, **kwargs)):
            if q:
                expected[q] = out
    for (_, body), payload in zip(results, payloads):
        assert body == json.loads(json.dumps(expected[payload["question"]]))
    # the decoded images reached the legs they were routed to
    routed = {q: {n: imgs[j] is not None for n, imgs in
                  kw["query_images"].items()}
              for qs, kw in recorded.calls for j, q in enumerate(qs) if q}
    assert routed[world["queries"][0]] == dict.fromkeys(names, True)
    assert routed[world["queries"][1]] == {"img": False, "clip": False,
                                           "face": True}
    assert routed[world["queries"][2]] == dict.fromkeys(names, False)
