"""The port's training CLI (bioscan_clip_tpu_torch/cli/train_cl.py) end to
end on the CPU (`device=cpu`), on the synthetic HDF5 fixture, with a tiny
model (1-layer towers, width 32, dropout 0.1) in place of
`models.clip.load_clip_model` (the pattern of tests/test_cli.py:186):
GradCache over 2 microbatches with the merged stage 1, 2 epochs of 2 steps,
the eval phase after each, `last`, `best` and `config.yaml` written; a run
resumed from `last` as it stood after epoch 0 repeats the uninterrupted
run's epoch-1 losses bit for bit (same config, so the same schedule);
`tpu.steps_per_call=2` gives the epochs' losses and the `last` checkpoint of
one step per call, and runs one step per call under `accum_mode: micro`, as
in JAX; INSECT mode trains on the INSECT loaders with ColorJitter and
evaluates against the four splits merged, and raises without a label
tokenizer;
`tpu.fast_ln` builds bf16 LayerNorms; `train_epoch` hands wandb one `loss`
record per step; one process asking for a mesh of several devices
raises."""

import ast
import os
import shutil

import numpy as np
import pytest

from test_torch_train_loader import synthetic_dataset
from tests.fixtures import SyntheticArgs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def dataset_path():
    return synthetic_dataset()


def tiny_factory(args, device=None, dtype=None, lora_rank=None,
                 ln_dtype=None, **_):
    """`load_clip_model` at tiny width, seeded like it."""
    import torch

    from bioscan_clip_tpu_torch.models.bert import (
        BarcodeBertDnaEncoder,
        BertConfig,
        BertTextEncoder,
    )
    from bioscan_clip_tpu_torch.models.clip import (
        MultiModalCLIP,
        init_weights,
    )
    from bioscan_clip_tpu_torch.models.vit import ViTConfig, ViTImageEncoder

    rank = 2 if lora_rank is None else lora_rank
    dtype = dtype or torch.float32
    ln_dtype = ln_dtype or torch.float32
    kw = dict(hidden_size=32, num_layers=1, num_heads=2,
              intermediate_size=64, lora_rank=rank)
    model = MultiModalCLIP(
        image_encoder=ViTImageEncoder(ViTConfig(
            image_size=224, patch_size=32, hidden_size=32, num_layers=1,
            num_heads=2, num_classes=32, lora_rank=rank), dtype, ln_dtype),
        dna_encoder=BarcodeBertDnaEncoder(BertConfig(vocab_size=1027, **kw),
                                          32, dtype, ln_dtype),
        language_encoder=BertTextEncoder(BertConfig(vocab_size=30522, **kw),
                                         32, dtype, ln_dtype),
    )
    return init_weights(model.to(device), seed=0).eval()


@pytest.fixture
def args(dataset_path, tmp_path, monkeypatch):
    import bioscan_clip_tpu_torch.models.clip as port_clip

    monkeypatch.setattr(port_clip, "load_clip_model", tiny_factory)
    monkeypatch.chdir(tmp_path)
    a = SyntheticArgs(dataset_path, batch_size=8)
    a.cfg.merge({
        "project_root_path": str(tmp_path),
        "model_output_dir": "ckpt",
        "save_ckpt": True,
        "debug_flag": False,
        "activate_wandb": False,
        "device": "cpu",
        "inference_and_eval_setting": {"k_list": [1, 3, 5]},
        "tpu": {"accum_steps": 2, "max_steps_per_epoch": 2},
    })
    a.cfg.model_config.merge({"epochs": 2, "evaluation_period": 1,
                              "load_ckpt": False, "model_output_name": "tc"})
    return a


def _losses(lines, epoch):
    prefix = f"epoch {epoch} losses "
    return ast.literal_eval(next(ln[len(prefix):] for ln in lines
                                 if ln.startswith(prefix)))


def test_train_cl_gradcache_checkpoints_and_bit_equal_resume(args,
                                                            tmp_path):
    from bioscan_clip_tpu_torch.cli import train_cl
    from bioscan_clip_tpu_torch.train.checkpoint import wait_for_checkpoints

    copy = tmp_path / "after_epoch_0"
    lines = []

    def out(line):
        lines.append(line)
        if line.startswith("Last ckpt: ") and not copy.exists():
            wait_for_checkpoints()  # `last` as it stood after epoch 0
            copy.mkdir()
            shutil.copy(line[len("Last ckpt: "):], copy / "last")

    state, best = train_cl.run(args, out=out)
    assert state.step == 4 and best is not None
    assert any("merged (rank-0) towers" in ln for ln in lines)
    runs = tmp_path / "ckpt" / "tc"
    folder = runs / sorted(os.listdir(runs))[-1]
    assert {"last", "best", "config.yaml"} <= set(os.listdir(folder))
    first = _losses(lines, 1)
    assert len(first) == 2 and len(_losses(lines, 0)) == 2

    args.cfg.merge({"resume": str(copy)})
    again = []
    state2, _ = train_cl.run(args, out=again.append)
    assert any("Resumed from" in ln and "(epoch 1)" in ln for ln in again)
    assert not any(ln.startswith("epoch 0 losses") for ln in again)
    assert _losses(again, 1) == first  # bit for bit
    assert state2.step == 4


@pytest.fixture
def insect_args(args, tmp_path):
    """`args` in INSECT mode over the JAX package's INSECT fixture
    (tests/test_insect.py), built from its seed."""
    import tests.test_insect as ti

    class Factory:
        def mktemp(self, name):
            p = tmp_path / name
            p.mkdir()
            return p

    jax_args = ti.insect_fixture.__wrapped__(Factory())
    args.cfg.merge({"insect_data": dict(jax_args.cfg.insect_data)})
    args.cfg.model_config.merge({"dataset": "INSECT"})
    return args


def test_insect_mode_and_steps_per_call_raise(insect_args, monkeypatch):
    """INSECT mode no longer raises for want of a port (it runs:
    `test_train_cl_insect_mode`); without a BERT-small vocabulary its label
    tokenizer (`transformers` unimportable) raises, where the JAX loader
    falls back to salted hash() ids;
    `tpu.steps_per_call` does not raise (its runs:
    `test_steps_per_call_equals_one_step_per_call`)."""
    from bioscan_clip_tpu_torch.cli import train_cl
    from test_torch_train_loader import without_transformers

    monkeypatch.delenv("BSCAN_BERT_VOCAB", raising=False)
    monkeypatch.delenv("BIOSCAN_CLIP_TPU_ALLOW_DOWNLOAD", raising=False)
    insect_args.cfg.tpu.merge({"steps_per_call": 2})
    with without_transformers(), pytest.raises(RuntimeError,
                                               match="BSCAN_BERT_VOCAB"):
        train_cl.run(insect_args)


def test_train_cl_insect_mode(insect_args, tmp_path, monkeypatch):
    """INSECT mode end to end (JAX train_cl.py:76-89, :193-238, :336-349):
    the INSECT loaders, ColorJitter in every step's augmentation draw,
    GradCache 2 x 4, and the eval phase over the four splits merged into
    the keys (12 train + 6 val + 3 test-seen + 3 test-unseen records) with
    test seen and unseen as the queries."""
    import bioscan_clip_tpu_torch.retrieval.report as report
    import bioscan_clip_tpu_torch.train.loop as loop
    from bioscan_clip_tpu_torch.cli import train_cl

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                 "[MASK]", "order", "family", "genus", "_",
                                 "0", "1", "2", "3"]) + "\n")
    monkeypatch.setenv("BSCAN_BERT_VOCAB", str(vocab))
    flags, sweeps = [], []
    real_draw = loop.draw_train_aug
    real_sweep = report.inference_and_print_result

    def draw(*a, jitter=False, **kw):
        flags.append(jitter)
        return real_draw(*a, jitter=jitter, **kw)

    def sweep(keys, seen, unseen, **kw):
        sweeps.append((len(keys["label_list"]), len(seen["label_list"]),
                       len(unseen["label_list"])))
        return real_sweep(keys, seen, unseen, **kw)

    monkeypatch.setattr(loop, "draw_train_aug", draw)
    monkeypatch.setattr(report, "inference_and_print_result", sweep)
    lines = []
    state, best = train_cl.run(insect_args, out=lines.append)
    assert state.step == 2  # 2 epochs of the one full batch of 8 of 12
    assert best is not None and 0.0 <= best <= 1.0
    assert flags and all(flags)
    assert sweeps == [(24, 3, 3)] * 2
    assert all(np.isfinite(_losses(lines, e)).all() for e in (0, 1))


def test_steps_per_call_equals_one_step_per_call(args, tmp_path):
    """`tpu.steps_per_call=2` (GradCache, 2 steps per call) gives the
    epochs' losses and the `last` checkpoint (model, AdamW state, step,
    generator) of one step per call; under `accum_mode: micro` it runs one
    step per call, as JAX's CLI does."""
    import torch

    from bioscan_clip_tpu_torch.cli import train_cl

    runs = {}
    for k in (1, 2):
        args.cfg.tpu.merge({"steps_per_call": k})
        args.cfg.model_config.merge({"model_output_name": f"k{k}"})
        lines = []
        train_cl.run(args, out=lines.append)
        runs[k] = ([_losses(lines, e) for e in (0, 1)], lines)
    assert runs[2][0] == runs[1][0] and len(runs[1][0][1]) == 2
    assert any("2 train steps per call" in ln for ln in runs[2][1])

    def last(name):
        folder = tmp_path / "ckpt" / name
        return torch.load(folder / sorted(os.listdir(folder))[-1] / "last",
                          weights_only=True)

    a, b = last("k1"), last("k2")
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["generator"], b["generator"])
    for key, t in a["state_dict"].items():
        assert torch.equal(t, b["state_dict"][key]), key
    for i, st in a["optimizer"]["state"].items():
        for key, t in st.items():
            assert torch.equal(t, b["optimizer"]["state"][i][key]), (i, key)

    args.cfg.tpu.merge({"accum_mode": "micro", "steps_per_call": 2,
                        "max_steps_per_epoch": 1})
    args.cfg.model_config.merge({"epochs": 1})
    args.cfg.merge({"save_ckpt": False})
    assert train_cl.steps_per_call_of(args) == 1
    lines = []
    state, _ = train_cl.run(args, out=lines.append, skip_final_eval=True)
    assert state.step == 1
    assert not any("per call" in ln for ln in lines)


def test_the_cli_needs_cuda_unless_the_cpu_is_asked(args):
    import torch

    from bioscan_clip_tpu_torch.cli import train_cl

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    args.cfg.pop("device")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cl.run(args)


def test_fast_ln_builds_bf16_layernorms(args):
    """`tpu.fast_ln` was accepted and ignored; it now gives every tower
    (and GradCache's merged stage-1 towers) bf16 LayerNorms, as JAX's
    `BSCAN_FAST_LN` does, and the run trains with them."""
    import torch

    from bioscan_clip_tpu_torch.cli import train_cl
    from bioscan_clip_tpu_torch.models.common import LayerNorm

    def lns(model):
        # the BarcodeBERT MLM transform's LayerNorm stays fp32, as in JAX
        # (bert.py:318-320)
        return [m.compute_dtype for n, m in model.named_modules()
                if isinstance(m, LayerNorm) and ".transform." not in n]

    assert train_cl.ln_dtype_of(args) == torch.float32
    args.cfg.merge({"save_ckpt": False})
    args.cfg.tpu.merge({"max_steps_per_epoch": 1, "fast_ln": True})
    args.cfg.model_config.merge({"epochs": 1})
    state, _ = train_cl.run(args, skip_final_eval=True)
    dtypes = lns(state.model)
    assert len(dtypes) > 6 and set(dtypes) == {torch.bfloat16}
    assert train_cl.ln_dtype_of(args) == torch.bfloat16


def test_train_epoch_logs_loss_every_step():
    """JAX's `train_epoch` logs `loss`, `epoch` and `step` to wandb every
    step (loop.py:1135-1136); the port's logged nothing per step."""
    from types import SimpleNamespace

    import torch

    from bioscan_clip_tpu_torch.train.loop import train_epoch

    class FakeRun:
        def __init__(self):
            self.records = []

        def log(self, metrics, commit=True):
            self.records.append(dict(metrics))

    state = SimpleNamespace(device=torch.device("cpu"))
    losses = iter([3.0, 2.5, 2.0])

    def step(state, batch, seed):
        return state, torch.tensor(next(losses))

    run = FakeRun()
    batches = [{"labels": torch.zeros(4, dtype=torch.int64)}] * 3
    _, stats = train_epoch(state, step, batches, torch.Generator(), 1, 2,
                           wandb_run=run)
    assert run.records == [{"loss": v, "epoch": 1, "step": i}
                           for i, v in enumerate([3.0, 2.5, 2.0])]
    assert stats["losses"] == [3.0, 2.5, 2.0]


def test_one_process_asking_for_several_devices_raises(args):
    """`tpu.mesh_shape` was accepted and ignored. One process naming a
    mesh of several devices raises (the card idiom is one process per
    card); {data: -1} over the one device of this process trains; an axis
    other than `data` raises and names itself."""
    from bioscan_clip_tpu_torch.cli import train_cl

    args.cfg.merge({"save_ckpt": False})
    args.cfg.tpu.merge({"mesh_shape": {"data": 2}})
    with pytest.raises(ValueError, match="one process per card"):
        train_cl.run(args, skip_final_eval=True)
    args.cfg.tpu.merge({"mesh_shape": {"data": 1, "model": 2}})
    with pytest.raises(ValueError, match="'model'"):
        train_cl.run(args, skip_final_eval=True)
    args.cfg.tpu.mesh_shape = {"data": -1}  # replaced, not merged
    args.cfg.tpu.merge({"max_steps_per_epoch": 1})
    args.cfg.model_config.merge({"epochs": 1})
    state, _ = train_cl.run(args, skip_final_eval=True)
    assert state.step == 1
