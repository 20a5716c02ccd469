"""Cells of kind "search": classification by retrieval in a closed loop.

The service is built as `cli/serve.build_service` builds it, with the
benchmark's weights in place of a checkpoint: `models.clip.load_clip_model`
for the configuration, the weights loaded, `maybe_merge_lora` (the
configuration's `tpu.merge_lora`), a `RetrievalService` with the
configuration's `serve` options, and the key database of its `serve_keys`
installed through `set_keys`. One client sends the mix's requests one
after another, each `search(images=..., k=...)` on uint8 frames from the
pool; a request's latency runs from the call to its answer (the service
fetches every answer to the host). Set-up sends each request size twice.

The window keeps the answers of a share of its requests drawn from the
seed before it opens, and drops the rest as they come. The check takes
kept requests that the window answered, drawn from the seed (the first
one of the largest size among them), and computes their
answers again with the plain reference in float32: the served image path,
the image tower its geometry names (OpenCLIP's, its LoRA merged), the
scores of every key, the top k. The numbers compared are the widest gap between a served
similarity and the reference's score of the same rank, and the widest gap
by which the best key carrying a served species label lies below the
reference's score of that rank (a label that is no species of the
database's taxonomy reads LABEL_FAULT).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import flops, gen, reference as ref
from benchmark.weights import make_weights

# requests in a traced span, rounded up to whole rounds of the mix's sizes
TRACED_REQUESTS = 12
LABEL_FAULT = 4.0  # above any gap of two cosines
REF_BLOCK = 64
# the share of requests whose answers the window keeps for the check; the
# rest are dropped as they come, so that the client's own garbage does not
# grow the collector's work in the window
KEEP_SHARE = 1 / 16


class _OpenClipVisual:
    """The reference of OpenCLIP's image tower, its LoRA merged once."""

    def __init__(self, p, g):
        self.p, self.g = p, g
        self.merged = ref.merge_openclip_lora(p, g)

    def __call__(self, x, nx):
        return ref.openclip_visual(self.p, self.g, x, nx, self.merged)


# the reference of each image tower a search cell can serve, by the "tower"
# its geometry names: (weights, geometry) -> images, numerics -> embeddings
REF_TOWERS = {"openclip_visual": _OpenClipVisual}


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.g = cfg["geometry"]
        self.keys_cfg = cfg["serve_keys"]
        self.k = traffic["k"]
        self.errors = []
        tower = self.g["image"]["tower"]
        if tower not in REF_TOWERS or tower not in flops.FORWARD_TOWERS:
            raise ValueError(f"a search cell has no reference or FLOP count "
                             f"of the image tower {tower!r}")
        if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
            raise ValueError("a search mix here is a closed loop of one "
                             f"client, not {traffic.get('loop')!r} x "
                             f"{traffic.get('clients')!r}")

    def setup(self):
        from bioscan_clip_tpu_torch.config.core import ConfigNode
        from bioscan_clip_tpu_torch.device import compute_dtype
        from bioscan_clip_tpu_torch.models.clip import (
            load_clip_model,
            maybe_merge_lora,
        )
        from bioscan_clip_tpu_torch.retrieval.service import RetrievalService

        dev = self.device
        parts, t = {}, time.perf_counter()
        args = ConfigNode({"model_config": self.cfg["model_config"],
                           "tpu": self.cfg["tpu"],
                           "serve": self.cfg["serve"]})
        sv = args.serve
        dtype = compute_dtype(dev)
        model = load_clip_model(args, device=dev, dtype=dtype)
        model.load_state_dict(make_weights(self.g, self.seed, dev),
                              strict=True)
        model = maybe_merge_lora(args, model, device=dev, dtype=dtype)
        self.service = RetrievalService(
            model, device=dev, max_k=int(sv.get("max_k", 5)),
            max_batch=int(sv.get("max_batch", 256)),
            openclip_norm=bool(self.cfg["model_config"].get("for_open_clip",
                                                            False)),
            image_host_parity=bool(sv.get("image_host_parity", True)),
            key_precision=str(sv.get("key_precision", "high")),
            key_rescore=str(sv.get("key_rescore", "bfloat16")))
        parts["model"] = time.perf_counter() - t
        t = time.perf_counter()
        keys, _, labels = gen.key_database(self.keys_cfg,
                                           self.g["image"]["output_dim"],
                                           self.seed, dev)
        keys = keys.cpu().numpy()
        self.service.set_keys(keys, labels)
        del keys, labels
        parts["keys"] = time.perf_counter() - t
        t = time.perf_counter()
        self.make_requests()
        parts["requests"] = time.perf_counter() - t
        t = time.perf_counter()
        for plates in sorted(set(self.tr["plates"])) * 2:
            n = plates * self.tr["plate_size"]
            self.service.search(images=list(self.pool[:n]), k=self.k)
        gc.collect()
        parts["warm_up"] = time.perf_counter() - t
        self.setup_parts = parts

    def make_requests(self):
        """The frame pool, the schedule of requests and the requests whose
        answers are kept for the check (the first, the first of the
        largest size, and a share drawn from the seed)."""
        self.pool = gen.frame_pool(self.tr, self.seed, self.device)
        self.schedule = gen.search_schedule(self.tr, self.seed,
                                            self.tr["schedule_requests"])
        self.next_request = 0
        top = max(p for p, _ in self.schedule)
        rng = np.random.default_rng(gen.sub_seed(self.seed, 7))
        drawn = rng.random(len(self.schedule)) < KEEP_SHARE
        self.keep = {0, next(i for i, (p, _) in enumerate(self.schedule)
                             if p == top)}
        self.keep |= set(np.flatnonzero(drawn).tolist())

    def scheduled_records(self, count: int):
        """Records of the schedule's first `count` requests as answered
        ones, for readings that put the reference in the program's
        place."""
        self.records = [{"request": i, "plates": p, "queries": len(idx),
                         "ok": True}
                        for i, (p, idx) in enumerate(self.schedule[:count])]
        return self.records

    def _send(self):
        """The next request of the schedule -> (record, answer or None)."""
        plates, idx = self.schedule[self.next_request % len(self.schedule)]
        images = [self.pool[i] for i in idx]
        t = time.perf_counter()
        try:
            out = self.service.search(images=images, k=self.k)
        except Exception as e:  # a failed request is counted, not raised
            out = None
            self.errors.append(f"{type(e).__name__}: {e}")
        rec = {"request": self.next_request, "plates": plates,
               "queries": len(idx), "seconds": time.perf_counter() - t}
        self.next_request += 1
        return rec, out

    def _well_formed(self, out, n: int) -> bool:
        if out is None:
            return False
        preds, sims = out.get("predictions"), out.get("similarities")
        return (isinstance(preds, list) and len(preds) == n
                and len(sims) == n
                and all(len(s) == self.k for s in sims)
                and all(len(p[lvl]) == self.k for p in preds
                        for lvl in gen.LEVELS))

    def window(self, seconds: float) -> dict:
        self.records, self.answers, self.errors = [], {}, []
        t0 = time.perf_counter()
        while not self.records or time.perf_counter() - t0 < seconds:
            rec, out = self._send()
            rec["ok"] = self._well_formed(out, rec["queries"])
            self.records.append(rec)
            if rec["ok"] and rec["request"] in self.keep:
                self.answers[rec["request"]] = out
            del out
        dt = time.perf_counter() - t0
        ok = [r for r in self.records if r["ok"]]
        lat = np.array([r["seconds"] for r in self.records]) * 1e3
        self.window_rate = sum(r["queries"] for r in ok) / dt
        return {"attempted": len(self.records),
                "failed": len(self.records) - len(ok),
                "metrics": {"search_queries_per_s": self.window_rate,
                            "search_p95_ms": float(np.percentile(lat, 95))},
                "requests": len(self.records), "seconds": dt,
                "setup_parts": getattr(self, "setup_parts", None),
                "errors": self.errors[:3]}

    def traced(self):
        from benchmark.trace_agg import traced_call

        sizes = len(self.tr["plates"])
        n = -(-TRACED_REQUESTS // sizes) * sizes
        recs = []

        def run():
            for _ in range(n):
                recs.append(self._send()[0])

        _, wall_ms, agg = traced_call(run, self.device)
        return agg, wall_ms, self.work([r["queries"] for r in recs])

    def work(self, sizes) -> dict:
        """The shapes of requests of `sizes` queries, for the readers."""
        g = self.g["image"]
        n = flops.tower_tokens(g)
        hd = g["hidden"] // g["heads"]
        d, nk = g["output_dim"], self.keys_cfg["count"]
        calls = [("fwd", q, n, g["heads"], hd, False)
                 for q in sizes for _ in range(g["layers"])]
        per_query = flops.forward_flops(g) + flops.search_flops(nk, d)
        return {"kind": "search", "requests": len(sizes),
                "queries": sum(sizes), "attention_calls": calls,
                "topk_calls": [(q, nk, d, self.k) for q in sizes],
                "untraced_queries_per_s": self.window_rate,
                "flops_per_query": per_query}

    def free(self):
        self.service = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------------

    def sample(self):
        """The answered requests the check compares: of those kept, the
        first answered one of the largest size, then others drawn from the
        seed, up to `check_queries` queries."""
        done = [r for r in self.records
                if r["ok"] and r["request"] in self.keep]
        if not done:
            return []
        top = max(r["plates"] for r in done)
        first = next(r for r in done if r["plates"] == top)
        rng = np.random.default_rng(gen.sub_seed(self.seed, 6))
        out, total = [first], first["queries"]
        for i in rng.permutation(len(done)):
            r = done[i]
            if r is first or total + r["queries"] > self.tr["check_queries"]:
                continue
            out.append(r)
            total += r["queries"]
        return out

    def reference_answers(self, reqs, precision="float32",
                          search_dtype=torch.float32):
        """{request: (top-k scores (n, k), species ids (n, k), per-request
        scores of the best key of each species (n, species))} from the
        reference. `precision` rounds the tower's products (the control:
        "fp8"); `search_dtype` rounds the search's operands (the control:
        bfloat16)."""
        dev, g = self.device, self.g["image"]
        nx = ref.Numerics(precision)
        keys, species, _ = gen.key_database(self.keys_cfg, g["output_dim"],
                                            self.seed, dev)
        nsp = self.keys_cfg["species"]
        out = {}
        with ref.no_tf32(), torch.no_grad():
            tower = REF_TOWERS[g["tower"]](make_weights(self.g, self.seed,
                                                        dev), g)
            for r in reqs:
                idx = self.schedule[r["request"] % len(self.schedule)][1]
                vals, sps, best = [], [], []
                for s in range(0, len(idx), REF_BLOCK):
                    fr = torch.from_numpy(self.pool[idx[s:s + REF_BLOCK]]).to(
                        dev)
                    x = ref.eval_crop(fr, self.cfg["serve_crop"],
                                      g["image_size"])
                    if self.cfg["model_config"].get("for_open_clip"):
                        x = ref.clip_normalize(x)
                    e = ref.l2n(tower(x, nx))
                    sc = torch.matmul(e.to(search_dtype),
                                      keys.to(search_dtype).t()).float()
                    v, i = torch.topk(sc, self.k, dim=1)
                    vals.append(v)
                    sps.append(species[i])
                    b = torch.full((sc.shape[0], nsp), -4.0, device=dev)
                    best.append(b.scatter_reduce_(
                        1, species[None, :].expand(sc.shape[0], -1), sc,
                        reduce="amax"))
                out[r["request"]] = (torch.cat(vals).cpu(),
                                     torch.cat(sps).cpu(),
                                     torch.cat(best).cpu())
        return out

    def program_answers(self, reqs):
        """{request: (served similarities (n, k), served species ids (n, k),
        or -1 where a label is no species of the taxonomy)}."""
        out = {}
        for r in reqs:
            ans = self.answers[r["request"]]
            out[r["request"]] = (
                torch.tensor(ans["similarities"], dtype=torch.float32),
                torch.tensor([[self._species_of(pred, j) for j in
                               range(self.k)] for pred in ans["predictions"]]))
        return out

    def _species_of(self, pred, j) -> int:
        name = pred["species"][j]
        try:
            s = int(name.removeprefix("species"))
        except ValueError:
            return -1
        if not 0 <= s < self.keys_cfg["species"]:
            return -1
        want = gen.taxonomy(s, self.keys_cfg)
        if any(pred[lvl][j] != want[lvl] for lvl in gen.LEVELS):
            return -1
        return s

    def compare(self, got: dict, want: dict) -> dict:
        if not want or set(got) != set(want):
            return {"sim_gap": LABEL_FAULT, "label_gap": LABEL_FAULT}
        sim_gap = label_gap = 0.0
        for key, (vals, _, best) in want.items():
            gs, gsp = got[key][0], got[key][1]
            sim_gap = max(sim_gap, float((gs - vals).abs().max()))
            if bool((gsp < 0).any()):
                label_gap = LABEL_FAULT
                continue
            served = best.gather(1, gsp)
            label_gap = max(label_gap, float((vals - served).max()))
        return {"sim_gap": sim_gap, "label_gap": max(label_gap, 0.0)}

    def check(self) -> dict:
        reqs = self.sample()
        return self.compare(self.program_answers(reqs),
                            self.reference_answers(reqs))

    def control_answers(self, reqs) -> dict:
        """The control in the program's place: the tower's products in fp8,
        the search's operands in bfloat16."""
        ans = self.reference_answers(reqs, "fp8", torch.bfloat16)
        return {k: (v[0], v[1]) for k, v in ans.items()}
