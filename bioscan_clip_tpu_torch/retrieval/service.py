"""Retrieval serving: raw inputs -> embeddings -> taxonomy.

Counterpart of bioscan_clip_tpu/retrieval/service.py:38-318. One loaded
model and one key database resident on the device (`PreparedKeys`) answer
queries end to end: JPEG bytes or uint8 arrays / DNA barcode strings /
taxonomy label strings / embeddings in, per-level top-k taxonomy out.

Inputs run through the towers in power-of-two buckets (excess rows repeat
the last row and are dropped from the output), as the JAX service does to
reuse one compiled program per bucket; here it keeps the kernels' shapes to
a small set. Images take the torchvision-exact host eval path, or with
`image_host_parity=False` a shorter-side-256 center crop on the host and
the antialiased eval transform on the device (`data/transforms.
eval_transform`). `key_precision="int8"` keeps int8 key codes resident and
rescores on the host rows kept in `key_rescore` ("bfloat16" by default, as
the JAX service does; "float32" exact; "none" the quantized scores).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bioscan_clip_tpu_torch.device import resolve_device
from bioscan_clip_tpu_torch.retrieval.engine import (
    LEVELS,
    PreparedKeys,
    make_prediction,
)


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class RetrievalService:
    """One loaded model + one resident key database, many queries.

    `device` defaults to cuda (an error when CUDA is missing); the model is
    moved there. `vocab_path` is the BERT-small `vocab.txt` for text
    queries (None: the tokenizer's own fallbacks)."""

    def __init__(self, model, keys=None, key_labels=None, *, device=None,
                 mesh=None, max_k: int = 5, max_batch: int = 256,
                 openclip_norm: bool = False, image_host_parity: bool = True,
                 key_precision: str = "high", key_rescore: str = "bfloat16",
                 vocab_path=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        self.max_k = max_k
        self.max_batch = max_batch
        self.openclip_norm = openclip_norm
        self.image_host_parity = image_host_parity
        self.key_precision = key_precision
        self.key_rescore = key_rescore
        self.vocab_path = vocab_path
        self.prepared = None
        self.key_labels = None
        if keys is not None:
            self.set_keys(keys, key_labels)

    # ---------------- key database ----------------

    def set_keys(self, keys, key_labels):
        """Install the key database: (N, D) float features + N label dicts
        (order/family/genus/species), normalized and uploaded once."""
        keys = np.asarray(keys, np.float32)
        if key_labels is None or len(key_labels) != keys.shape[0]:
            raise ValueError(
                "key_labels must provide one label dict per key row"
            )
        self.prepared = PreparedKeys(keys, device=self.device,
                                     precision=self.key_precision,
                                     rescore=self.key_rescore,
                                     mesh=self.mesh)
        self.key_labels = list(key_labels)

    @classmethod
    def from_export(cls, model, export_hdf5: str,
                    feature_type: str = "encoded_image_feature", **kw):
        """Build from an `extract_embedding` export (per-level label
        datasets + per-modality feature datasets)."""
        from bioscan_clip_tpu_torch.data import h5file

        with h5file.File(export_hdf5, "r") as f:
            if feature_type not in f:
                raise KeyError(
                    f"{feature_type!r} not in {export_hdf5} "
                    f"(has {sorted(f.keys())})"
                )
            feats = np.asarray(f[feature_type], np.float32)
            levels = {
                lvl: [s.decode() if isinstance(s, bytes) else str(s)
                      for s in f[lvl][()]]
                for lvl in LEVELS
            }
        labels = [
            {lvl: levels[lvl][i] for lvl in LEVELS}
            for i in range(feats.shape[0])
        ]
        return cls(model, keys=feats, key_labels=labels, **kw)

    # ---------------- embedding ----------------

    def _to_device(self, x):
        if isinstance(x, dict):
            return {k: self._to_device(v) for k, v in x.items()}
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _encoder(self, name: str):
        """`encode_<name>`; "image_u8" is the image tower behind the device
        eval transform of a uint8 (B, 256, 256, 3) batch."""
        if name != "image_u8":
            return getattr(self.model, f"encode_{name}")
        from bioscan_clip_tpu_torch.data.transforms import eval_transform

        def encode(x):
            return self.model.encode_image(
                eval_transform(x, normalize=self.openclip_norm))

        return encode

    def _run_bucketed(self, name: str, x, n: int):
        """Run `encode_<name>` over n rows in power-of-two padded buckets."""
        encode = self._encoder(name)

        def rows(a, s, take, b):
            a = a[s : s + take]
            if b > take:  # pad by repeating the last row; dropped below
                a = np.concatenate([a, np.repeat(a[-1:], b - take, axis=0)])
            return a

        out = []
        s = 0
        with torch.inference_mode():
            while s < n:
                take = min(n - s, self.max_batch)
                b = _bucket(take, self.max_batch)
                if isinstance(x, dict):
                    chunk = {k: rows(v, s, take, b) for k, v in x.items()}
                else:
                    chunk = rows(x, s, take, b)
                emb = encode(self._to_device(chunk))
                out.append(emb.float().cpu().numpy()[:take])
                s += take
        return np.concatenate(out, axis=0)

    def embed_images(self, images: Sequence,
                     host_parity: Optional[bool] = None) -> np.ndarray:
        """images: JPEG/PNG bytes or decoded uint8 HWC arrays (any sizes).

        `host_parity=True` (default from the constructor): torchvision-
        exact host eval preprocessing. False: cv2 shorter-side resize to 256
        (skipped when it already is 256) and a 256x256 center crop on the
        host, then the antialiased resize/crop on the device."""
        from bioscan_clip_tpu_torch.data.transforms import (
            decode_jpeg,
            host_eval_image,
            host_resize_shorter,
        )

        if self.model.image_encoder is None:
            raise ValueError("model has no image tower")
        if host_parity is None:
            host_parity = self.image_host_parity
        decoded = [
            decode_jpeg(im) if isinstance(im, (bytes, bytearray))
            else np.asarray(im)
            for im in images
        ]
        if host_parity:
            pre = np.stack([
                host_eval_image(im, normalize=self.openclip_norm)
                for im in decoded
            ]).astype(np.float32)
            return self._run_bucketed("image", pre, pre.shape[0])
        crops = []
        for im in decoded:
            r = host_resize_shorter(np.asarray(im, np.uint8), 256)
            h, w = r.shape[:2]
            top, left = (h - 256) // 2, (w - 256) // 2
            crops.append(r[top : top + 256, left : left + 256])
        pre = np.stack(crops)
        return self._run_bucketed("image_u8", pre, pre.shape[0])

    def embed_dna(self, barcodes: Sequence[str]) -> np.ndarray:
        """barcodes: raw COI nucleotide strings, 5-mer tokenized as in
        training (data/tokenizers.py)."""
        from bioscan_clip_tpu_torch.data.tokenizers import tokenize_dna_batch

        if self.model.dna_encoder is None:
            raise ValueError("model has no DNA tower")
        toks = tokenize_dna_batch(list(barcodes)).astype(np.int64)
        return self._run_bucketed("dna", toks, toks.shape[0])

    def embed_text(self, labels: Sequence[str],
                   vocab_path: Optional[str] = None) -> np.ndarray:
        """labels: 'order family genus species' strings, tokenized with
        BERT-small WordPiece."""
        from bioscan_clip_tpu_torch.data.tokenizers import (
            tokenize_labels_bert_small,
        )

        if self.model.language_encoder is None:
            raise ValueError("model has no language tower")
        toks = tokenize_labels_bert_small(
            list(labels), vocab_path=vocab_path or self.vocab_path
        )
        x = {k: np.asarray(v, np.int64) for k, v in toks.items()}
        return self._run_bucketed("language", x, x["input_ids"].shape[0])

    # ---------------- search ----------------

    def search_embeddings(self, embeddings, k: Optional[int] = None):
        """(B, D) query embeddings -> (per-level top-k label dicts,
        similarities)."""
        if self.prepared is None:
            raise ValueError("no key database installed (set_keys)")
        k = int(k) if k else self.max_k
        if not 1 <= k <= self.max_k:
            raise ValueError(f"k must be in [1, {self.max_k}], got {k}")
        preds, sims = make_prediction(
            np.asarray(embeddings, np.float32), self.prepared,
            self.key_labels, with_similarity=True, max_k=k,
        )
        return preds, np.asarray(sims)

    def search(self, *, images=None, dna=None, text=None, embeddings=None,
               k: Optional[int] = None, vocab_path=None):
        """One-call serve: exactly one input kind -> top-k taxonomy."""
        given = [x is not None for x in (images, dna, text, embeddings)]
        if sum(given) != 1:
            raise ValueError(
                "provide exactly one of images/dna/text/embeddings"
            )
        if images is not None:
            emb = self.embed_images(images)
        elif dna is not None:
            emb = self.embed_dna(dna)
        elif text is not None:
            emb = self.embed_text(text, vocab_path=vocab_path)
        else:
            emb = np.asarray(embeddings, np.float32)
        preds, sims = self.search_embeddings(emb, k=k)
        return {"predictions": preds, "similarities": sims.tolist()}

    def info(self) -> dict:
        return {
            "status": "ok",
            "n_keys": 0 if self.prepared is None else self.prepared.n_keys,
            "max_k": self.max_k,
            "towers": [
                n for n in ("image", "dna", "language")
                if getattr(self.model, f"{n}_encoder") is not None
            ],
            "backend": self.device.type,
        }


def handle_request(service: RetrievalService, body: dict) -> dict:
    """Shared JSON request handler for the HTTP server and batch mode.

    Body: {"dna": [...]} | {"image_b64": [...]} | {"text": [...]} |
    {"embedding": [[...]]}, optional "k"."""
    import base64

    k = body.get("k")
    if "dna" in body:
        return service.search(dna=body["dna"], k=k)
    if "text" in body:
        return service.search(text=body["text"], k=k)
    if "image_b64" in body:
        imgs = [base64.b64decode(s) for s in body["image_b64"]]
        return service.search(images=imgs, k=k)
    if "embedding" in body:
        return service.search(embeddings=body["embedding"], k=k)
    raise ValueError(
        "body must contain one of: dna, text, image_b64, embedding"
    )
