"""Online/batch retrieval serving for a trained BIOSCAN-CLIP model, on the
card.

Counterpart of bioscan_clip_tpu/cli/serve.py:33-202: load the towers and a
resident key database once, then answer taxonomy queries over HTTP or from
a JSON file.

    # HTTP daemon
    python -m bioscan_clip_tpu_torch.cli.serve 'model_config=NAME' \\
        'serve.keys=.../extracted_features_of_all_keys.hdf5' \\
        'serve.feature_type=encoded_image_feature' 'serve.port=8901'

    # one-shot batch: read a request JSON, print the response JSON
    python -m bioscan_clip_tpu_torch.cli.serve 'model_config=NAME' \\
        'serve.keys=...' 'serve.once=queries.json'

`tpu.mesh_shape` ({data: N} or {data: -1}) shards the key database over
this host's cards (`parallel/mesh.py`, JAX serve.py:77).
`serve.device` picks the device (default `cuda`, an error without CUDA;
`cpu` runs the kernels' plain versions). `serve.vocab_path` is the
BERT-small vocab.txt for text queries. `serve.key_precision=default`
searches the fp32 keys in one bf16 pass (kernel K4, operands rounded to
bf16, fp32 sums), as the TPU's `Precision.DEFAULT`; `int8` keeps the
key database as per-row int8 codes on the device (kernel K5, 4x the keys
of fp32); `serve.key_rescore` picks the host rows its candidates are
rescored against: `bfloat16` (default, half the host memory), `float32`
(exact scores) or `none` (no host copy, the quantized scores).

API (also the `serve.once` file schema):
    GET  /healthz                         -> service info
    POST /embed  {"dna": [...]} | {"image_b64": [...]} | {"text": [...]}
                                          -> {"embeddings": [[...]]}
    POST /search same inputs or {"embedding": [[...]]}, optional "k"
                                          -> {"predictions": [{level: [top-k
                                             labels]}], "similarities": ...}
"""

from __future__ import annotations

import json
import os
import sys


def build_service(args, out=print):
    from bioscan_clip_tpu_torch.device import compute_dtype, resolve_device
    from bioscan_clip_tpu_torch.interop.weights import (
        load_into,
        load_reference_pth,
        resolve_reference_ckpt,
    )
    from bioscan_clip_tpu_torch.models.clip import (
        load_clip_model,
        maybe_merge_lora,
    )
    from bioscan_clip_tpu_torch.parallel.mesh import mesh_from_config
    from bioscan_clip_tpu_torch.retrieval.service import RetrievalService

    mc = args.model_config
    sv = getattr(args, "serve", {}) or {}
    device = resolve_device(sv.get("device", "cuda"))
    dtype = compute_dtype(device)
    load_ckpt = getattr(mc, "load_ckpt", True)
    ckpt_path = getattr(mc, "ckpt_path", None)
    if ckpt_path and os.path.isdir(ckpt_path):
        ckpt_path = resolve_reference_ckpt(ckpt_path) or ckpt_path
    if load_ckpt and not (ckpt_path and os.path.isfile(ckpt_path)):
        # a retrieval service on random weights answers garbage — be loud
        # (load_ckpt=false is the explicit no-align opt-out)
        raise FileNotFoundError(
            f"serve: no checkpoint at model_config.ckpt_path="
            f"{getattr(mc, 'ckpt_path', None)!r}; set a valid .pth (or "
            "directory containing best.pth/last.pth), or pass "
            "model_config.load_ckpt=false to serve random-init towers "
            "deliberately"
        )
    out(f"Initialize model on {device} ({dtype})...")
    model = load_clip_model(args, device=device, dtype=dtype)
    if load_ckpt:
        load_into(model, load_reference_pth(ckpt_path))
        out(f"Loaded {ckpt_path}")
    model = maybe_merge_lora(args, model, device=device, dtype=dtype)
    kw = dict(
        device=device,
        mesh=mesh_from_config(args, device),
        max_k=int(sv.get("max_k", 5)),
        max_batch=int(sv.get("max_batch", 256)),
        openclip_norm=bool(getattr(mc, "for_open_clip", False)),
        image_host_parity=bool(sv.get("image_host_parity", True)),
        key_precision=str(sv.get("key_precision", "high")),
        key_rescore=str(sv.get("key_rescore", "bfloat16")),
        vocab_path=sv.get("vocab_path"),
    )
    keys_path = sv.get("keys")
    if keys_path:
        out(f"Loading key database from {keys_path} ...")
        service = RetrievalService.from_export(
            model, keys_path,
            feature_type=sv.get("feature_type", "encoded_image_feature"),
            **kw,
        )
        out(f"Key database resident: {service.prepared.n_keys} keys")
    else:
        service = RetrievalService(model, **kw)
    return service


def make_handler(service):
    from http.server import BaseHTTPRequestHandler

    from bioscan_clip_tpu_torch.retrieval.service import handle_request

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet access log
            pass

        def do_GET(self):
            if self.path in ("/healthz", "/"):
                self._send(200, service.info())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/search":
                    self._send(200, handle_request(service, body))
                elif self.path == "/embed":
                    import base64

                    if "dna" in body:
                        emb = service.embed_dna(body["dna"])
                    elif "text" in body:
                        emb = service.embed_text(body["text"])
                    elif "image_b64" in body:
                        emb = service.embed_images(
                            [base64.b64decode(s)
                             for s in body["image_b64"]]
                        )
                    else:
                        raise ValueError(
                            "need one of: dna, text, image_b64"
                        )
                    self._send(200, {"embeddings": emb.tolist()})
                else:
                    self._send(404, {"error": "not found"})
            except Exception as e:  # serving: report, don't die
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def run(args, out=print):
    from http.server import ThreadingHTTPServer

    from bioscan_clip_tpu_torch.retrieval.service import handle_request

    service = build_service(args, out=out)
    sv = getattr(args, "serve", {}) or {}

    once = sv.get("once")
    if once:
        with open(once) as f:
            body = json.load(f)
        result = handle_request(service, body)
        output = sv.get("output")
        text = json.dumps(result)
        if output:
            with open(output, "w") as f:
                f.write(text)
            out(f"Wrote {output}")
        else:
            print(text)
        return result

    port = int(sv.get("port", 8901))
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(service))
    out(f"Serving on :{port} (GET /healthz, POST /embed, POST /search)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        out("shutting down")
    finally:
        httpd.server_close()


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    argv = argv if argv is not None else sys.argv[1:]
    args = load_config(overrides=list(argv))
    return run(args)


if __name__ == "__main__":
    main()
