"""Cells of kind "train": the program's contrastive train step, as
`cli/train_cl.make_step` builds it for the configuration, driven by
`train/loop.train_epoch` over batches resident on the device.

Set-up builds the model, loads the benchmark's weights, stores the frozen
leaves as `tpu.frozen_dtype` says, makes the train state and the step, and
runs the mix's first `checked_steps` steps through `train_epoch` on
distinct batches: the first call alone (AdamW's first moment is read after
it, the first gradient as the optimizer got it), then the rest (the
parameters are read after them). Those calls build and warm up every
kernel of the step. The window hands the same state and step more batches
until `--seconds` have passed; the rate is all its samples over all its
time, ending in the loop's own synchronize.

The check runs the plain reference over the checked steps, from the same
weights, batches, step seeds and draws, with torch's AdamW, once the
program is freed. Each step's loss comes from the towers' embeddings of
the whole batch; the gradient reaches the trained leaves block by block
of rows (the loss's gradient with respect to the embeddings, then each
block's backward), which is the full-batch gradient, computed in float32.
"""

from __future__ import annotations

import statistics
import time

import torch

from benchmark import flops, gen, reference as ref
from benchmark.weights import make_weights, model_spec, trainable

# the dropout salt of each role's rows; the reference of each tower a train
# cell can hold, by the "tower" its geometry names: (weights, geometry, the
# role's inputs, numerics, row seeds) -> embeddings
SALTS = {"dna": 0x0D5A17, "language": 0x7A9C33}
REF_TOWERS = {
    "vit": lambda p, g, x, nx, seeds: ref.vit_b16(p, g, x, nx),
    "barcode_bert": lambda p, g, x, nx, seeds: ref.barcode_bert(
        p, g, x, nx, seeds=seeds),
    "bert_small": lambda p, g, x, nx, seeds: ref.bert_small(
        p, g, x["input_ids"], x["attention_mask"], nx, seeds=seeds),
}
ROLES = ("image", "dna", "language")
BETAS = (0.9, 0.999)
TRACED_STEPS = 3


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.g = cfg["geometry"]
        for role in ROLES:
            tower = self.g[role]["tower"]
            if tower not in REF_TOWERS or tower not in flops.TRAIN_TOWERS:
                raise ValueError(f"a train cell has no reference or FLOP "
                                 f"count of the {role} tower {tower!r}")
        self.step_base = gen.sub_seed(seed, 5)
        self.frozen_bf16 = cfg["tpu"].get("frozen_dtype") in ("bfloat16",
                                                              "bf16")

    # --- the program ------------------------------------------------------

    def setup(self):
        from bioscan_clip_tpu_torch.cli.train_cl import ln_dtype_of, make_step
        from bioscan_clip_tpu_torch.config.core import ConfigNode
        from bioscan_clip_tpu_torch.device import compute_dtype
        from bioscan_clip_tpu_torch.models.clip import load_clip_model
        from bioscan_clip_tpu_torch.train.loop import train_epoch
        from bioscan_clip_tpu_torch.train.schedules import build_schedule
        from bioscan_clip_tpu_torch.train.state import (
            cast_frozen_params,
            create_train_state,
        )

        self.train_epoch = train_epoch
        dev = self.device
        parts, t = {}, time.perf_counter()
        args = ConfigNode({"model_config": self.cfg["model_config"],
                           "tpu": self.cfg["tpu"], "device": str(dev)})
        mc = args.model_config
        dtype = compute_dtype(dev)
        model = load_clip_model(args, device=dev, dtype=dtype,
                                ln_dtype=ln_dtype_of(args))
        parts["model"] = time.perf_counter() - t
        model.load_state_dict(make_weights(self.g, self.seed, dev,
                                           self.frozen_bf16), strict=True)
        disable_lora = bool(getattr(mc, "disable_lora", False))
        if self.frozen_bf16 and dtype == torch.bfloat16:
            cast_frozen_params(model, disable_lora=disable_lora)
        schedule = build_schedule(mc, self.tr["schedule_steps"])
        self.state = create_train_state(model, schedule,
                                        disable_lora=disable_lora,
                                        seed=self.step_base)
        self.step = make_step(args, model, dtype, out=lambda *_: None)
        parts["weights_state_step"] = time.perf_counter() - t - parts["model"]
        t = time.perf_counter()
        self.pool = [gen.train_batch(self.tr, self.seed, i, dev)
                     for i in range(self.tr["pool"])]
        self.next_batch = 0
        n = self.tr["checked_steps"]
        params = dict(model.named_parameters())
        self._sync()
        parts["batches"] = time.perf_counter() - t
        t = time.perf_counter()
        losses = self._run(self._batches(1))
        parts["first_step"] = time.perf_counter() - t
        opt = self.state.optimizer
        self.grad1 = {name: (opt.state[p]["exp_avg"] / (1 - BETAS[0])).cpu()
                      for name, p in params.items() if p in opt.state}
        t = time.perf_counter()
        losses += self._run(self._batches(n - 1))
        parts["checked_steps"] = time.perf_counter() - t
        self.losses = losses
        self.params = {name: p.detach().to("cpu", torch.float32, copy=True)
                       for name, p in params.items()}
        self._sync()
        self.setup_parts = parts

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batches(self, n):
        out = []
        for _ in range(n):
            out.append(self.pool[self.next_batch % len(self.pool)])
            self.next_batch += 1
        return out

    def _run(self, feed):
        self.state, stats = self.train_epoch(
            self.state, self.step, feed, self.state.generator, 0, 1,
            log_every=1 << 30)
        return list(stats["losses"])

    def window(self, seconds: float) -> dict:
        steps = []

        def feed():
            t_end = time.perf_counter() + seconds
            while not steps or time.perf_counter() < t_end:
                steps.append(1)
                yield self._batches(1)[0]

        t0 = time.perf_counter()
        losses = self._run(feed())
        dt = time.perf_counter() - t0
        b = self.tr["batch"]
        bad = sum(1 for v in losses if not v == v or abs(v) == float("inf"))
        self.window_rate = len(losses) * b / dt
        return {"attempted": len(steps), "failed": bad,
                "metrics": {"train_samples_per_s": self.window_rate},
                "steps": len(losses), "seconds": dt,
                "setup_parts": self.setup_parts,
                "loss_median": statistics.median(losses)}

    def traced(self):
        """The aggregate of TRACED_STEPS whole steps under the profiler, and
        the work they hold."""
        from benchmark.trace_agg import traced_call

        feed = self._batches(TRACED_STEPS)
        _, wall_ms, agg = traced_call(lambda: self._run(feed), self.device)
        return agg, wall_ms, self.work(TRACED_STEPS)

    def work(self, steps: int) -> dict:
        """The shapes of `steps` steps, for the per-layer readers."""
        b, g = self.tr["batch"], self.g
        calls = []
        for role in ROLES:
            t, n, bias = g[role], self.tokens(role), role == "language"
            hd = t["hidden"] // t["heads"]
            for _ in range(t["layers"] * steps):
                calls.append(("fwd", b, n, t["heads"], hd, bias))
                calls.append(("bwd", b, n, t["heads"], hd, bias))
        return {"kind": "train", "steps": steps, "samples": steps * b,
                "attention_calls": calls,
                "untraced_samples_per_s": self.window_rate,
                "flops_per_sample": self.flops_per_sample()}

    def tokens(self, role: str) -> int:
        """The tokens a sample of `role` holds in the step."""
        if role == "image":
            return flops.tower_tokens(self.g["image"])
        return self.tr["dna_tokens" if role == "dna" else "text_tokens"]

    def flops_per_sample(self) -> float:
        """The step's model FLOPs a sample, each tower counted by the
        "tower" its geometry names (`flops.TRAIN_TOWERS`; 118.47 GFLOP for
        the flagship)."""
        return sum(flops.train_flops(self.g[role], self.tokens(role))
                   for role in ROLES)

    def free(self):
        for name in ("state", "step", "pool"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------------

    def reference_run(self, precision: str = "float32", rows=None) -> dict:
        """The reference's checked steps: losses, the first gradient and
        the parameters after them, float32 on the host. `precision`: the
        products' operand rounding (`reference.Numerics`); `rows`: the rows
        of each batch it trains on (a fault planted in the reference)."""
        dev, g, tr = self.device, self.g, self.tr
        nx = ref.Numerics(precision)
        n = tr["checked_steps"]
        with ref.no_tf32():
            p = make_weights(g, self.seed, dev, self.frozen_bf16)
            train = {k: v.clone().requires_grad_(True) for k, v in p.items()
                     if trainable(k)}
            p.update(train)
            opt = torch.optim.AdamW(list(train.values()), lr=self._lr(),
                                    betas=BETAS, eps=1e-8, weight_decay=0.01)
            losses, grad1 = [], None
            seeds = ref.step_seeds(self.step_base, n)
            for s in range(n):
                batch = gen.train_batch(tr, self.seed, s % tr["pool"], dev)
                if rows is not None:
                    batch = _take(batch, rows)
                opt.zero_grad(set_to_none=True)
                losses.append(self._ref_step(p, batch, seeds[s], nx))
                if s == 0:
                    grad1 = {k: v.grad.detach().cpu() for k, v in
                             train.items()}
                opt.step()
            params = {k: v.detach().cpu() for k, v in p.items()}
        return {"losses": losses, "grad1": grad1, "params": params}

    def _lr(self) -> float:
        lr = self.cfg["model_config"].get("lr_config", {}).get("lr", 1e-3)
        if self.cfg["model_config"].get("lr_scheduler") is not None:
            raise ValueError("the reference steps a constant learning rate")
        return float(lr)

    def _ref_step(self, p, batch, step_seed, nx) -> float:
        """One step's loss; the trained leaves' gradients accumulated."""
        g, dev = self.g, self.device
        b = batch["labels"].shape[0]
        h, w = batch["image_u8"].shape[1:3]
        rows_all = batch.get("row_ids", torch.arange(b, device=dev))
        # the draws are made for the whole batch; a fault planted in the
        # reference keeps some rows (`_take`) with their own draws and seeds
        aug = _select(ref.draw_train_aug(step_seed, self.tr["batch"], h, w),
                      rows_all.cpu())
        seeds = {role: ref.row_seeds(step_seed, salt, rows_all, dev)
                 for role, salt in SALTS.items()}
        blk = self.tr["reference_block"]

        def embed(r):
            x = {"image": ref.train_augment(batch["image_u8"][r],
                                            _select(aug, r.cpu())),
                 "dna": batch["dna"][r],
                 "language": {k: v[r] for k, v in batch["language"].items()}}
            return [REF_TOWERS[g[role]["tower"]](
                p, g[role], x[role], nx,
                seeds[role][r] if role in seeds else None)
                for role in ROLES]

        blocks = [torch.arange(s, min(s + blk, b), device=dev)
                  for s in range(0, b, blk)]
        with torch.no_grad():
            parts = [embed(r) for r in blocks]
        embs = [torch.cat([pt[m] for pt in parts]).requires_grad_(True)
                for m in range(3)]
        loss = ref.contrastive_loss(embs, batch["labels"],
                                    self.cfg["logit_scale"])
        loss.backward()
        for r in blocks:
            out = embed(r)
            torch.autograd.backward(out, [e.grad[r] for e in embs])
        return float(loss.detach())

    def program_readings(self) -> dict:
        return {"losses": self.losses, "grad1": self.grad1,
                "params": self.params}

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers compared: the widest relative gap of a step's loss,
        and, by the worst leaf, the gap between the norms of the first
        gradient and of the change over the checked steps, each against
        the reference's norm of that leaf or of the median leaf, whichever
        is larger. A trained leaf whose reference gradient is under a
        thousandth of the median leaf's stays out of the change; a frozen
        leaf is held to no change at all."""
        p0 = {k: v.cpu() for k, v in make_weights(
            self.g, self.seed, self.device, self.frozen_bf16).items()}
        names = [n for n, _, _ in model_spec(self.g)]
        train = [n for n in names if trainable(n)]
        if len(got["losses"]) != len(want["losses"]):
            return {"loss_gap": 1e9, "grad_gap": 1e9, "change_gap": 1e9}
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(got["losses"], want["losses"]))

        def norm(d, k):
            v = d.get(k)
            return 0.0 if v is None else float(v.double().norm())

        gr = {k: norm(want["grad1"], k) for k in train}
        gmed = statistics.median(gr.values())
        grad_gaps = {k: abs(norm(got["grad1"], k) - gr.get(k, 0.0))
                     / max(gr.get(k, 0.0), gmed)
                     for k in names if k in gr or k in got["grad1"]}
        grad_gap = max(grad_gaps.values())
        moved = [k for k in train if gr[k] >= 1e-3 * gmed]

        def change(d, k):
            return float((d["params"][k].double() - p0[k].double()).norm())

        cr = {k: change(want, k) for k in moved}
        cmed = statistics.median(cr.values())
        change_gaps = {k: abs(change(got, k) - cr[k]) / max(cr[k], cmed)
                       for k in moved}
        change_gaps.update({k: change(got, k) / cmed for k in names
                            if not trainable(k)})
        change_gap = max(change_gaps.values())
        # the worst leaves, for the readings that set the limits
        self.worst = {
            "grad": sorted(grad_gaps.items(), key=lambda kv: -kv[1])[:3],
            "change": sorted(change_gaps.items(), key=lambda kv: -kv[1])[:3],
            "loss": [list(got["losses"]), list(want["losses"])],
            "median_grad": gmed, "median_change": cmed,
            "left_out": sorted(set(train) - set(moved))}
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "change_gap": change_gap}

    def check(self) -> dict:
        return self.compare(self.program_readings(), self.reference_run())


def _take(batch, rows):
    """The rows `rows` of a batch, with their global row ids."""
    out = {k: ({kk: vv[rows] for kk, vv in v.items()} if isinstance(v, dict)
               else v[rows]) for k, v in batch.items()}
    out["row_ids"] = torch.as_tensor(rows, device=batch["labels"].device)
    return out


def _select(aug, rows):
    """The draws of rows `rows` of a batch's augmentation draw."""
    return {k: tuple(t[rows] for t in v) if isinstance(v, tuple) else v[rows]
            for k, v in aug.items()}
