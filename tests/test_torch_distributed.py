"""Training and search over two processes (torch.distributed, gloo, on the
CPU) against one process on the rank-ordered concatenation of their rows
(bioscan_clip_tpu_torch/parallel/, train/loop.py, retrieval/engine.py,
cli/train_cl.py). The JAX counterpart is tests/test_multiprocess.py.

One worker pair (this file run as a script) covers every mode in one
spawn: the plain step, GradCache with a chunked stage 1, micro
accumulation at n = 4 over W = 2, the plain step fed by the loader's
process-strided shards, the supervised fine-tune's classifier and joint
steps (every weight trainable, train/fine_tuning.py), the sharded search,
and the CLI. The model is a
tiny tri-modal one (1-layer towers, width 32, dropout 0.1, perturbed
adapters, a learnable logit scale) fed uint8 frames that take the device
train augmentation, so every per-row draw is sliced from the global
batch's.

Bounds (those of tests/test_multiprocess.py): losses rtol 2e-5 against the
one-process run and 1e-6 between the ranks; each trainable tensor's sum of
|p| after two AdamW steps, and of |g| of its last gradient, rtol 2e-5 (the
gathered rows and the summed gradients are the one-process sums grouped
otherwise). The sharded search
equals the one-process search exactly (the same plain products per
shard); the CLI's losses are the same on both ranks and only rank 0
writes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, W, STEPS, SEED = 16, 2, 2, 0x5EED


def tiny_model(lora_rank=2, **_):
    """1-layer towers at width 32, dropout 0.1, seeded; adapters B
    perturbed so both adapter matrices train from the first step (rank 0:
    the merged towers GradCache's stage 1 runs on)."""
    from bioscan_clip_tpu_torch.models.bert import (
        BarcodeBertDnaEncoder,
        BertConfig,
        BertTextEncoder,
    )
    from bioscan_clip_tpu_torch.models.clip import MultiModalCLIP, init_weights
    from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder

    f32 = torch.float32
    kw = dict(hidden_size=32, num_layers=1, num_heads=2,
              intermediate_size=64, lora_rank=lora_rank)
    model = MultiModalCLIP(
        image_encoder=ViTImageEncoder(ViTConfig(
            image_size=224, patch_size=32, hidden_size=32, num_layers=1,
            num_heads=2, num_classes=32, lora_rank=lora_rank), f32, f32),
        dna_encoder=BarcodeBertDnaEncoder(BertConfig(vocab_size=1027, **kw),
                                          32, f32, f32),
        language_encoder=BertTextEncoder(BertConfig(vocab_size=30522, **kw),
                                         32, f32, f32),
    )
    model = init_weights(model, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "linear_b" in name or name.endswith("w_b.weight"):
                p.normal_(0.0, 0.02, generator=gen)
    return model


def host_batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    mask = (np.arange(12)[None, :]
            < rng.integers(4, 13, size=(b, 1))).astype(np.int64)
    labels = np.arange(b)
    labels[1] = labels[0]  # a positive pair across the first rows
    return {
        "image_u8": rng.integers(0, 256, size=(b, 48, 64, 3),
                                 dtype=np.uint8),
        "dna": rng.integers(0, 1027, size=(b, 24)),
        "language": {"input_ids": rng.integers(0, 30522, size=(b, 12)) * mask,
                     "token_type_ids": np.zeros((b, 12), np.int64),
                     "attention_mask": mask},
        "labels": labels,
    }


def _rows(batch, rows):
    return {k: _rows(v, rows) if isinstance(v, dict) else v[rows]
            for k, v in batch.items()}


def _fingerprint(model, skip=()):
    """Each trainable tensor's sum of |p|, then of its last gradient's
    |g|: AdamW's first steps hardly see a gradient's scale, so the
    gradients are compared too. `skip`: name endings of tensors left
    out."""
    ps = [p for n, p in model.named_parameters()
          if p.requires_grad and not n.endswith(skip)]
    return ([float(p.detach().double().abs().sum()) for p in ps]
            + [float(p.grad.double().abs().sum()) for p in ps
               if p.grad is not None])


def _factory(mode, model, mesh):
    from bioscan_clip_tpu_torch.train import loop

    if mode == "gradcache":
        return loop.make_gradcache_train_step(model, 4, s1_chunk=4,
                                              mesh=mesh)
    if mode == "accum":
        return loop.make_accum_train_step(model, 4, mesh=mesh)
    return loop.make_train_step(model, mesh=mesh)


def train(mode, batches, mesh=None):
    """STEPS steps of `mode` over `batches` (host dicts, this process's
    rows) -> (losses, fingerprint)."""
    from bioscan_clip_tpu_torch.train import schedules
    from bioscan_clip_tpu_torch.train.loop import (
        device_batch,
        make_logit_scale_param,
    )
    from bioscan_clip_tpu_torch.train.state import create_train_state

    model = make_logit_scale_param(tiny_model())
    state = create_train_state(model, schedules.constant(1e-3))
    step = _factory(mode, model, mesh)
    losses = []
    for i, batch in enumerate(batches):
        state, loss = step(state, device_batch(batch, "cpu"), SEED + i)
        losses.append(float(loss))
    return losses, _fingerprint(model)


def train_classifier(mode, batches, mesh=None):
    """STEPS fine-tune steps: the image classifier ("classifier") or the
    image and DNA classifiers ("joint") over the tiny towers, 4 classes,
    heads seeded -> (losses, fingerprint)."""
    from bioscan_clip_tpu_torch.models.clip import init_weights
    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.train import fine_tuning as ft

    clip = tiny_model()
    heads = [EncoderWithHead(tower, 32, 4) for tower in
             (clip.image_encoder, clip.dna_encoder)]
    for seed, clf in enumerate(heads):
        init_weights(clf.new_linear_layer, seed=3 + seed)
    if mode == "joint":
        step = ft.make_joint_classifier_train_step(*heads, mesh=mesh)
        model = step.model
    else:
        model = heads[0]
        step = ft.make_classifier_train_step(model, mesh=mesh)
    state = ft.create_fine_tune_state(model)
    losses = []
    for i, batch in enumerate(batches):
        tb = {"input": torch.from_numpy(batch["image_u8"]),
              "image": torch.from_numpy(batch["image_u8"]),
              "dna": torch.from_numpy(batch["dna"]),
              "target": torch.from_numpy(batch["labels"] % 4)}
        state, loss = step(state, tb, SEED + i)
        losses.append(float(loss))
    # BERT's key bias trains here, and its gradient is zero in exact
    # arithmetic (a softmax ignores a shift of a row): fp32 noise, which
    # AdamW scales by its own size
    return losses, _fingerprint(model, skip=("attention.self.key.bias",))


def loader_args(path, batch_size=4):
    from bioscan_clip_tpu_torch.config.core import ConfigNode

    return ConfigNode({
        "model_config": {
            "dataset": "bioscan_1m", "batch_size": batch_size,
            "output_dim": 32, "epochs": 1, "evaluation_period": 1,
            "using_train_seen_for_pre_train": True,
            "model_output_name": "mp", "load_ckpt": False,
            "image": {"input_type": "image", "model": "lora_vit"},
            "dna": {"input_type": "sequence", "model": "lora_barcode_bert"},
            "language": {"input_type": "sequence", "model": "lora_bert"}},
        "bioscan_data": {"path_to_hdf5_data": path},
        "bioscan_5m_data": {"path_to_hdf5_data": path},
        "save_inference": False, "debug_flag": False, "save_ckpt": True,
        "activate_wandb": False, "device": "cpu",
        "tpu": {"eval_host_parity_resize": False},
    })


def loader_batches(path, rank, world):
    from bioscan_clip_tpu_torch.data.dataset import construct_dataloader

    loader = construct_dataloader(
        loader_args(path), "no_split_and_seen_train", for_pre_train=True,
        shuffle=True, process_index=rank, process_count=world)
    it = iter(loader)
    out = [next(it) for _ in range(STEPS)]
    it.close()
    return out


def search_case():
    rng = np.random.default_rng(3)
    keys = rng.standard_normal((203, 64)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    keys[150:] = keys[:53]  # ties across the two shards
    q = keys[[0, 7, 160]] + 0.01 * rng.standard_normal((3, 64)).astype(
        np.float32)
    return q, keys


def search(mesh=None):
    from bioscan_clip_tpu_torch.retrieval import engine

    q, keys = search_case()
    out = {}
    for precision in ("high", "int8"):
        v, i = engine.topk_search(q, keys, 7, mesh=mesh, device="cpu",
                                  precision=precision, rescore="none")
        out[precision] = [v.tolist(), i.tolist()]
    return out


def run_cli(path, out_dir, rank):
    import bioscan_clip_tpu_torch.models.clip as port_clip
    from bioscan_clip_tpu_torch.cli import train_cl

    port_clip.load_clip_model = lambda args, **kw: tiny_model(**kw)
    args = loader_args(path)
    args.merge({"project_root_path": out_dir, "model_output_dir": "ckpt",
                "tpu": {"accum_steps": 2, "max_steps_per_epoch": STEPS,
                        "mesh_shape": {"data": W}}})
    lines = []
    state, _ = train_cl.run(args, out=lines.append, skip_final_eval=True)
    # only rank 0's out() sees lines
    return {"steps": state.step, "lines": len(lines),
            "fingerprint": _fingerprint(state.model)}


def worker(rank, port, path, out_path, out_dir):
    """One rank of the pair: every mode, results to `out_path`."""
    from bioscan_clip_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from bioscan_clip_tpu_torch.parallel.mesh import create_mesh

    os.environ.update(BSCAN_COORDINATOR=f"localhost:{port}",
                      BSCAN_NUM_PROCESSES=str(W), BSCAN_PROCESS_ID=str(rank))
    assert maybe_initialize_distributed(device="cpu") == (rank, W)
    mesh = create_mesh({"data": W})
    mine = slice(rank * (B // W), (rank + 1) * (B // W))
    res = {}
    for mode in ("plain", "gradcache", "accum"):
        res[mode] = train(mode, [_rows(host_batch(s), mine)
                                 for s in range(STEPS)], mesh)
    res["loader"] = train("plain", loader_batches(path, rank, W), mesh)
    for mode in ("classifier", "joint"):
        res[mode] = train_classifier(mode, [_rows(host_batch(s), mine)
                                            for s in range(STEPS)], mesh)
    res["search"] = search(mesh)
    res["cli"] = run_cli(path, out_dir, rank)
    with open(out_path, "w") as f:
        json.dump(res, f)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both ranks' results, and the fixture path they read."""
    from test_torch_train_loader import synthetic_dataset

    path = synthetic_dataset()
    tmp = tmp_path_factory.mktemp("mp")
    port = _free_port()
    path_var = os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=path_var)
    procs, outs = [], []
    for rank in range(W):
        outs.append(tmp / f"rank{rank}.json")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(port),
             path, str(outs[-1]), str(tmp)],
            env=env, cwd=str(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [json.loads(o.read_text()) for o in outs], path, tmp


@pytest.mark.parametrize("mode", ["plain", "gradcache", "accum", "loader",
                                  "classifier", "joint"])
def test_two_processes_train_as_one(pair, mode):
    results, path, _ = pair
    if mode in ("classifier", "joint"):
        ref_losses, ref_fp = train_classifier(
            mode, [host_batch(s) for s in range(STEPS)])
    elif mode == "loader":  # the two shards in rank order
        parts = [loader_batches(path, r, W) for r in range(W)]
        batches = [{k: _cat([p[i][k] for p in parts])
                    for k in ("image_u8", "dna", "language", "labels")}
                   for i in range(STEPS)]
        ref_losses, ref_fp = train("plain", batches)
    else:
        ref_losses, ref_fp = train(mode, [host_batch(s)
                                          for s in range(STEPS)])
    (l0, fp0), (l1, fp1) = results[0][mode], results[1][mode]
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    np.testing.assert_allclose(fp0, fp1, rtol=1e-6)
    np.testing.assert_allclose(l0, ref_losses, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(fp0, ref_fp, rtol=2e-5)


def _cat(xs):
    if isinstance(xs[0], dict):
        return {k: _cat([x[k] for x in xs]) for k in xs[0]}
    return np.concatenate(xs)


def test_two_process_search_and_cli(pair):
    results, _, tmp = pair
    ref = search()
    for res in results:
        for precision in ("high", "int8"):
            vals, idx = res["search"][precision]
            assert idx == ref[precision][1], precision
            np.testing.assert_array_equal(vals, ref[precision][0])
    c0, c1 = results[0]["cli"], results[1]["cli"]
    assert c0["steps"] == c1["steps"] == STEPS
    assert c0["lines"] > 0 and c1["lines"] == 0  # rank 0 speaks
    np.testing.assert_allclose(c0["fingerprint"], c1["fingerprint"],
                               rtol=1e-6)
    runs = os.listdir(tmp / "ckpt" / "mp")
    assert len(runs) == 1  # one run folder, rank 0's


def test_micro_accumulation_needs_whole_microbatches_per_process():
    """n = 3 microbatches over W = 2 processes would cut one in two: it
    raises, as does a train step over several devices of one process."""
    from bioscan_clip_tpu_torch.parallel.mesh import Mesh
    from bioscan_clip_tpu_torch.train import loop

    model = tiny_model()
    pair_axis = Mesh((torch.device("cpu"),), 2, 0, group=object())
    with pytest.raises(ValueError, match="multiple of 2"):
        loop.make_accum_train_step(model, 3, mesh=pair_axis)
    one_process = Mesh((torch.device("cpu"),) * 2, 2)
    with pytest.raises(ValueError, match="one process per card"):
        loop.make_train_step(model, mesh=one_process)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           sys.argv[5])
