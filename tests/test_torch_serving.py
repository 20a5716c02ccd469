"""The serving slice as a whole: a JAX `RetrievalService` and a port
`RetrievalService(device="cpu")` on the same tiny tri-modal weights and the
same 40 labelled keys answer the same requests; plus an HTTP round trip
through the port's `cli/serve.make_handler` and `build_service`.

Tolerance: identical predictions and similarities within 1e-4 (the towers
agree to ~1e-5 in fp32, see test_torch_towers.py; the 40 random keys have
no near-ties at that level).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from bioscan_clip_tpu.retrieval.service import RetrievalService as JaxService
from bioscan_clip_tpu_torch.interop.weights import load_into, state_dict_from_jax
from bioscan_clip_tpu_torch.retrieval.service import (
    RetrievalService,
    handle_request,
)
from tests.test_torch_towers import D_OUT, jax_model, jax_params, port_model

SIM_ATOL = 1e-4
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "diptera",
         "lepidoptera", "cecidomyiidae", "noctuidae", "sciara", "##ra",
         "sp", "insecta", "a", "b"]
TEXT = ["diptera cecidomyiidae sciara sp", "lepidoptera noctuidae a b",
        "diptera unknown sciara"]


def _labels(n):
    return [{"order": f"o{i % 3}", "family": f"f{i % 5}",
             "genus": f"g{i % 7}", "species": f"s{i}"} for i in range(n)]


def _barcodes(n, seed=0):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), size=658)) for _ in range(n)]


def _images(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
            for h, w in ((256, 340), (300, 300), (260, 261))]


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    params = jax_params(seed=3)
    keys = np.random.default_rng(4).standard_normal((40, D_OUT)).astype(
        np.float32)
    jax_svc = JaxService(jax_model(), params, keys=keys,
                         key_labels=_labels(40), max_k=3, max_batch=8)
    model = load_into(port_model(), state_dict_from_jax(params))
    port_svc = RetrievalService(model, keys=keys, key_labels=_labels(40),
                                device="cpu", max_k=3, max_batch=8,
                                vocab_path=str(vocab))
    return jax_svc, port_svc, str(vocab)


def _same(a, b):
    assert a["predictions"] == b["predictions"]
    np.testing.assert_allclose(a["similarities"], b["similarities"],
                               atol=SIM_ATOL)


def test_search_by_dna(services):
    jax_svc, port_svc, _ = services
    _same(port_svc.search(dna=_barcodes(3), k=3),
          jax_svc.search(dna=_barcodes(3), k=3))


def test_search_by_text(services):
    jax_svc, port_svc, vocab = services
    _same(port_svc.search(text=TEXT, k=2),
          jax_svc.search(text=TEXT, k=2, vocab_path=vocab))


def test_search_by_images(services):
    jax_svc, port_svc, _ = services
    out = port_svc.search(images=_images(), k=3)
    _same(out, jax_svc.search(images=_images(), k=3))
    # bucket padding does not change a row
    solo = port_svc.embed_images(_images()[:1])
    np.testing.assert_allclose(solo[0], port_svc.embed_images(_images())[0],
                               atol=1e-6)


def test_search_by_embedding(services):
    jax_svc, port_svc, _ = services
    q = np.random.default_rng(5).standard_normal((4, D_OUT)).tolist()
    _same(handle_request(port_svc, {"embedding": q, "k": 2}),
          jax_svc.search(embeddings=q, k=2))


def test_device_eval_transform_and_bad_k_raise(services):
    """image_host_parity=False: host shorter-side-256 crop, then the device
    eval transform, as the JAX service does (JAX resizes the three frames
    on the host with the same cv2 call, then its device transform); a k
    beyond max_k raises."""
    jax_svc, port_svc, _ = services
    out = port_svc.embed_images(_images(), host_parity=False)
    ref = jax_svc.embed_images(_images(), host_parity=False)
    np.testing.assert_allclose(out, ref, atol=SIM_ATOL)
    with pytest.raises(ValueError):
        port_svc.search(embeddings=np.zeros((1, D_OUT)), k=4)


def test_http_round_trip(services):
    from http.server import ThreadingHTTPServer

    from bioscan_clip_tpu_torch.cli.serve import make_handler

    _, port_svc, _ = services
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(port_svc))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            info = json.loads(r.read())
        assert info["status"] == "ok" and info["n_keys"] == 40
        assert info["backend"] == "cpu"
        assert info["towers"] == ["image", "dna", "language"]

        def post(path, body):
            req = urllib.request.Request(
                url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        out = post("/search", {"dna": _barcodes(2), "k": 2})
        _same(out, port_svc.search(dna=_barcodes(2), k=2))
        emb = np.asarray(post("/embed", {"text": TEXT})["embeddings"])
        assert emb.shape == (3, D_OUT)
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0,
                                   atol=1e-5)
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/search", {"nope": 1})
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_build_service_flagship_on_cpu():
    """cli/serve.build_service assembles the flagship towers from a config
    built in code (no YAML), on the CPU when serve.device=cpu."""
    from bioscan_clip_tpu_torch.cli.serve import build_service
    from bioscan_clip_tpu_torch.config.core import ConfigNode

    mc = {"image": {"input_type": "image", "model": "lora_vit"},
          "dna": {"input_type": "sequence", "model": "lora_barcode_bert"},
          "language": {"input_type": "sequence", "model": "lora_bert"},
          "output_dim": 768, "load_ckpt": False}
    args = ConfigNode({"model_config": mc,
                       "serve": {"device": "cpu", "max_k": 2}})
    svc = build_service(args, out=lambda *_: None)
    assert svc.info()["towers"] == ["image", "dna", "language"]
    assert next(svc.model.parameters()).dtype == torch.float32
    keys = np.random.default_rng(6).standard_normal((10, 768))
    svc.set_keys(keys, _labels(10))
    out = svc.search(embeddings=keys[3:4], k=2)
    assert out["predictions"][0]["species"][0] == "s3"

    args.model_config["load_ckpt"] = True
    args.model_config["ckpt_path"] = "/nonexistent/best.pth"
    with pytest.raises(FileNotFoundError):
        build_service(args, out=lambda *_: None)


def test_config_tree_resolves_like_jax():
    """The port's copy of the YAML tree composes every model config exactly
    as the JAX package's does."""
    from pathlib import Path

    from bioscan_clip_tpu.config import core as jax_core
    from bioscan_clip_tpu_torch.config import core

    names = sorted(p.stem for p in
                   (Path(core.__file__).parent / "model_config").rglob("*.yaml"))
    assert len(names) == 19
    for name in names:
        a = core.load_config(model_config=name, project_root_path="/p")
        b = jax_core.load_config(model_config=name, project_root_path="/p")
        assert a.to_dict() == b.to_dict(), name


def test_main_serves_once_from_an_hdf5_export(tmp_path):
    """`python -m bioscan_clip_tpu_torch.cli.serve` with YAML overrides, an
    extract_embedding-style HDF5 key export and a `serve.once` request."""
    import h5py

    from bioscan_clip_tpu_torch.cli.serve import main

    keys = np.random.default_rng(7).standard_normal((12, 768)).astype(
        np.float32)
    labels = _labels(12)
    with h5py.File(tmp_path / "keys.hdf5", "w") as f:
        f["encoded_dna_feature"] = keys
        for lvl in ("order", "family", "genus", "species"):
            f[lvl] = np.asarray([r[lvl] for r in labels], dtype="S")
    (tmp_path / "req.json").write_text(
        json.dumps({"embedding": keys[[5, 2]].tolist(), "k": 2}))
    main([
        "model_config=lora_vit_lora_barcode_bert_lora_bert_5m",
        "model_config.load_ckpt=false", "serve.device=cpu",
        f"serve.keys={tmp_path / 'keys.hdf5'}",
        "serve.feature_type=encoded_dna_feature",
        f"serve.once={tmp_path / 'req.json'}",
        f"serve.output={tmp_path / 'out.json'}",
    ])
    out = json.loads((tmp_path / "out.json").read_text())
    assert [p["species"][0] for p in out["predictions"]] == ["s5", "s2"]
