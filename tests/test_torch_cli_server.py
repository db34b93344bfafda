"""The port's ``server`` command (viquae_torch/cli_aux.py
``build_server_from_config`` / ``cmd_server``) against the JAX package's
on the same configs and weights: the cases of tests/test_server.py:406-721
(a hybrid config, a VQA config with online image and face legs, HTTP end
to end with concurrent clients, and the command in a subprocess).

Each request is answered by both servers, one at a time (a batch of one
is the same batch in both), and the responses must agree: ids and answers
exactly, scores within 1e-5 or one bf16 ulp (tests/test_torch_cli.py); on the VQA
config, two passages whose scores lie within 1e-3 may swap ranks (see
``answer_agrees``).
Concurrent requests are held to the direct pipeline call on the batch the
service recorded. Every test runs under its own time limit, every server
thread and subprocess has a timeout and is shut down in a ``finally``.
"""
import argparse
import base64
import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cli import (BCFG, READER_BCFG, assert_scores_close,
                            dpr_model, reader_block, write)
from test_torch_server import time_limit
from viquae_torch.cli_aux import build_server_from_config as tbuild
from viquae_tpu.cli_aux import build_server_from_config as jbuild

from test_torch_cli import ws  # noqa: F401  (the module fixture)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def health(base, timeout=10):
    with urllib.request.urlopen(f"{base}/health", timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


class Served:
    """Both packages' servers of one config, each in a daemon thread."""

    def __init__(self, cfg, **kw):
        self.servers = {}
        for label, build, device in (("jax", jbuild, None),
                                     ("port", tbuild, torch.device("cpu"))):
            args = argparse.Namespace(
                config=str(cfg), host="127.0.0.1", port=0, k=5,
                m_passages=2, max_batch=4, max_wait_ms=10.0, **kw)
            if device is not None:
                args.device = device
            server, services = build(args)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            self.servers[label] = (server, services, thread)

    def base(self, label):
        return f"http://127.0.0.1:{self.servers[label][0].server_address[1]}"

    def both(self, path, payload):
        return {label: post(self.base(label) + path, payload)
                for label in self.servers}

    def close(self):
        for server, services, thread in self.servers.values():
            server.shutdown()
            thread.join(timeout=5)
            for s in services:
                s.close()


def search_agrees(out):
    (s_j, b_j), (s_t, b_t) = out["jax"], out["port"]
    assert s_j == s_t == 200, out
    assert b_t["indices"] == b_j["indices"]
    assert_scores_close(b_t["scores"], b_j["scores"])


def answer_agrees(out, tie=0.0):
    """Same answer; the same passage at every rank unless the two ranks'
    scores lie within ``tie`` of each other (near-ties at the rank cut
    may go either way: the JAX package alone orders them differently from
    run to run on the VQA config's random online legs)."""
    (s_j, b_j), (s_t, b_t) = out["jax"], out["port"]
    assert s_j == s_t == 200, out
    assert b_t["answer"] == b_j["answer"] and b_t["answer"] is not None
    assert len(b_t["passage_ids"]) == len(b_j["passage_ids"])
    for a, b, sa, sb in zip(b_j["passage_ids"], b_t["passage_ids"],
                            b_j["scores"], b_t["scores"]):
        assert a == b or abs(sa - sb) <= tie, (b_j, b_t)


@time_limit(240)
def test_cli_server_hybrid_config(ws, tmp_path):  # noqa: F811
    from viquae_torch.ir.serving import HybridRetrievalPipeline

    cfg = write(tmp_path / "server.json", {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"),
        "row_len": 16,
        "index": {"dataset": str(ws / "kb"), "column": "embedding",
                  "mode": "global"},
        "bm25": {"kb": str(ws / "kb"), "column": "passage", "b": 0.3,
                 "k1": 0.5},
        "weights": [0.7, 0.3]})
    served = Served(cfg)
    try:
        assert isinstance(served.servers["port"][1][0].pipeline,
                          HybridRetrievalPipeline)
        for query in ("w3 w4 w5", "w9", "w1 w2 w20 w21"):
            search_agrees(served.both("/search", {"query": query}))
    finally:
        served.close()


@time_limit(300)
def test_cli_server_vqa_config(ws, tmp_path):  # noqa: F811
    """A fusion config with an online CLIP ViT leg (an HF CLIPModel
    checkpoint) and an online face leg (facenet + insightface layout
    checkpoints) and a reader builds the pixels-in VQA service; image and
    text-only questions get the same answers from both packages."""
    from PIL import Image
    from transformers import CLIPConfig, CLIPModel

    from torch_helpers import jax_tree
    from viquae_torch.ir.server import BatchedVQAService
    from viquae_torch.models import arcface as tarc
    from viquae_torch.models import convert
    from viquae_torch.models import mtcnn as tm

    vision = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                  intermediate_size=32, image_size=32, patch_size=16)
    torch.save(CLIPModel(CLIPConfig(
        text_config=dict(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32,
                         max_position_embeddings=16),
        vision_config=vision, projection_dim=8)).state_dict(),
        tmp_path / "clip.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                convert.state_dict_from_tree(jax_tree(
                    tm.init(seed=3, device="cpu"))).items()},
               tmp_path / "mtcnn.pt")
    acfg = tarc.ArcFaceConfig(stage_sizes=(1, 1, 1, 1), width=8,
                              embedding_size=12)
    asd = {}
    for name, a in convert.state_dict_from_tree(jax_tree(
            tarc.init(acfg, seed=4, device="cpu"))).items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer{int(parts[1]) + 1}", parts[2]] + parts[3:]
        name = (".".join(parts).replace("downsample_conv", "downsample.0")
                .replace("downsample_bn", "downsample.1")
                .replace("features_bn", "features"))
        asd[name] = torch.from_numpy(a)
    torch.save(asd, tmp_path / "arcface.pt")

    from datasets import Dataset

    rng = np.random.default_rng(0)
    Dataset.from_dict({
        "embedding": rng.standard_normal((20, 16)).astype(
            np.float32).tolist(),
        "clip": rng.standard_normal((20, 8)).astype(np.float32).tolist(),
        "face": rng.standard_normal((20, 12)).astype(np.float32).tolist(),
        "passage": [f"w{i} w{i + 1} w{i + 2} w{i + 3}" for i in range(20)],
    }).save_to_disk(str(tmp_path / "kb"))
    kb = str(tmp_path / "kb")
    reader = reader_block(ws)
    reader["passages"] = kb
    cfg = write(tmp_path / "vqa.json", {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"),
        "row_len": 16,
        "indexes": {
            "dpr": {"dataset": kb, "column": "embedding", "mode": "global"},
            "clip": {"dataset": kb, "column": "clip", "mode": "global",
                     "do_l2norm": True},
            "face": {"dataset": kb, "column": "face", "mode": "global",
                     "do_l2norm": True}},
        "weights": {"dpr": 0.6, "clip": 0.2, "face": 0.2},
        "text_index": "dpr", "norm": "zmuv",
        "image_encoders": {"clip": {
            "model": "clip-vit", "weights": str(tmp_path / "clip.pt"),
            "model_config": {**vision, "projection_dim": 8},
            "image_size": 32}},
        "face_encoders": {"face": {
            "mtcnn": {"canvas": 128, "min_face_size": 40, "max_faces": 2,
                      "k_per_scale": 8, "k_stage1": 16, "k_stage2": 8,
                      "thresholds": [0.0, 0.0, 0.0]},
            "mtcnn_weights": str(tmp_path / "mtcnn.pt"),
            "arcface": {"stage_sizes": [1, 1, 1, 1], "width": 8,
                        "embedding_size": 12},
            "arcface_weights": str(tmp_path / "arcface.pt")}},
        **reader})
    served = Served(cfg)
    try:
        services = served.servers["port"][1]
        assert isinstance(services[0], BatchedVQAService)
        assert services[0].image_index_names == ["clip", "face"]
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8),
                        "RGB").save(buf, format="PNG")
        image = base64.b64encode(buf.getvalue()).decode()
        answer_agrees(served.both("/answer", {"question": "w1 w2 w3",
                                              "image_b64": image}), 1e-3)
        # a text-only question rides the same service (image legs masked)
        answer_agrees(served.both("/answer", {"question": "w7 w8"}), 1e-3)
        status, body = post(served.base("port") + "/answer",
                            {"question": "w1", "image_b64": "not base64!!"})
        assert status == 400
    finally:
        served.close()


@time_limit(240)
def test_cli_server_http_end_to_end(ws, tmp_path):  # noqa: F811
    """A dense config: 12 concurrent /search, each equal to the direct
    pipeline call on the batch the service recorded; /search with a
    batch and /health; the JAX server gives the same single answers."""
    cfg = write(tmp_path / "server.json", {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"),
        "row_len": 16, "index": {"dataset": str(ws / "kb"),
                                 "column": "embedding", "mode": "fused"}})
    served = Served(cfg)
    try:
        service = served.servers["port"][1][0]
        batches = []
        run_arrays = service.pipeline.run_arrays

        def recorded(queries):
            out = run_arrays(queries)
            batches.append((list(queries), out))
            return out

        service.pipeline.run_arrays = recorded
        queries = [f"w{i} w{(i * 7) % 30}" for i in range(12)]
        responses = [None] * len(queries)

        def client(i):
            responses[i] = post(served.base("port") + "/search",
                                {"query": queries[i]})

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        service.pipeline.run_arrays = run_arrays
        direct = {}
        for batch, (scores, ids) in batches:
            for j, q in enumerate(batch):
                direct[q] = (scores[j], ids[j])
        for q, (status, body) in zip(queries, responses):
            assert status == 200
            scores, ids = direct[q]
            assert body["indices"] == [int(i) for i in ids]
            np.testing.assert_allclose(body["scores"], scores, rtol=0,
                                       atol=1e-6)
        status, body = post(served.base("port") + "/search",
                            {"queries": queries[:3]})
        assert status == 200 and len(body["results"]) == 3
        status, info = health(served.base("port"))
        assert status == 200 and info["ok"]
        search_agrees(served.both("/search", {"query": queries[0]}))
    finally:
        served.close()


@time_limit(240)
def test_cli_server_subprocess(ws, tmp_path):  # noqa: F811
    """`python -m viquae_torch --device cpu server` over a real socket in
    a fresh process (the deployment shape), against the JAX server."""
    cfg = write(tmp_path / "server.json", {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"),
        "row_len": 16, "index": {"dataset": str(ws / "kb"),
                                 "column": "embedding", "mode": "global"}})
    proc = subprocess.Popen(
        [sys.executable, "-m", "viquae_torch", "--device", "cpu", "server",
         str(cfg), "--port", "0", "--k", "3", "--max-batch", "4",
         "--max-wait-ms", "20"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    served = None
    try:
        info = json.loads(proc.stdout.readline())
        base = info["listening"]
        assert info["endpoints"] == ["/search", "/health"]
        status, body = post(f"{base}/search", {"query": "w1 w2 w3"})
        assert status == 200 and len(body["indices"]) == 3
        status, h = health(base)
        assert status == 200 and h["ok"] and h["search"]["items"] == 1
        served = Served(cfg)
        status, ref = post(served.base("jax") + "/search",
                           {"query": "w1 w2 w3"})
        assert body["indices"] == ref["indices"][:3]
        assert_scores_close(body["scores"], ref["scores"][:3])
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        if served is not None:
            served.close()

