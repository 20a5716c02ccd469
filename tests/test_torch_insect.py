"""The port's INSECT path against the JAX package on the JAX INSECT fixture
(`tests/test_insect.py`: the .mat splits, a per-id image HDF5, the species
JSON), built once from its seed, its frames rewritten in four shapes:
- `load_insect_mat` (1-based indices) and every loader batch for batch
  against JAX's `InsectLoader`: uint8 frames (cv2-resized to the first
  frame's shape where they differ), DNA tokens, label tokens, ids, label
  dicts, train labels over two shuffled epochs and both process shards
  exactly equal; eval-parity float images within 1e-6. JAX's label
  tokenizer is replaced, in these tests only, by its WordPiece padded to
  the longest string over a small vocab written here; the port gets the
  same vocab and must give the same ids, and raises without a tokenizer;
- the INSECT CLIs end to end on the CPU (`device="cpu"`) with tiny models
  patched in: extraction into the two BZSL CSVs, then `bzsl_eval.run`
  (with and without tuning) giving the JSON of JAX's `bzsl_eval.run` on the
  same CSVs; the full ViT fine-tune (every parameter moves, the pre-head
  feature CSV); the joint fine-tune (dropout 0.1 in the DNA tower, its
  heads saved, the BZSL CSVs of the fine-tuned towers)."""

import json
import os

import numpy as np
import pytest
import torch

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "order", "family",
         "genus", "species", "not", "_", "0", "1", "2", "classified"]


@pytest.fixture(scope="module")
def insect(tmp_path_factory):
    """(JAX args, port args, vocab path) over the JAX INSECT fixture."""
    import h5py

    import tests.test_insect as ti
    from bioscan_clip_tpu_torch.config.core import ConfigNode
    from tests.fixtures import make_jpeg

    jax_args = ti.insect_fixture.__wrapped__(tmp_path_factory)
    root = tmp_path_factory.mktemp("insect_port")
    # the same records as frames of four shapes, so a batch mixes shapes
    # after the shorter-side resize
    ins = jax_args.cfg.insect_data
    with h5py.File(ins.path_to_image_hdf5, "r") as f:
        names = sorted(f["images"])
    sizes = [(64, 48), (48, 64), (56, 56), (72, 48)]
    path = root / "INSECT_images_mixed.hdf5"
    with h5py.File(path, "w") as f:
        g = f.create_group("images")
        for i, name in enumerate(names):
            jpg = make_jpeg((30 * (i % 4) + 40, 80, 120), size=sizes[i % 4],
                            seed=i)
            g.create_dataset(name, data=np.frombuffer(jpg, dtype=np.uint8))
    ins["path_to_image_hdf5"] = str(path)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    port_args = ConfigNode({
        "model_config": {"batch_size": 6, "output_dim": 32,
                         "evaluation_period": 1, "load_ckpt": False},
        "insect_data": dict(jax_args.cfg.insect_data),
        "general_fine_tune_setting": {"batch_size": 6, "epoch": 1},
        "inference_and_eval_setting": {"k_list": [1, 3, 5]},
        "project_root_path": str(root), "model_output_dir": "ckpt",
        "save_ckpt": True, "device": "cpu",
    })
    return jax_args, port_args, str(vocab)


def jax_longest_tokenizer(vocab):
    """JAX's WordPiece padded to the longest string (no truncation), the
    contract the port's `tokenize_labels_longest` keeps."""
    from bioscan_clip_tpu.data.wordpiece import WordPieceTokenizer

    def tokenize(strings):
        tok = WordPieceTokenizer(vocab)
        ids = [tok.encode(s, max_length=512) for s in strings]
        width = max(len(r) for r in ids)
        out = np.full((len(ids), width), tok.pad_id, np.int32)
        mask = np.zeros_like(out)
        for i, r in enumerate(ids):
            out[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return {"input_ids": out, "token_type_ids": np.zeros_like(out),
                "attention_mask": mask}

    return staticmethod(tokenize)


def jax_loader(jax_args, vocab, split, **kw):
    from bioscan_clip_tpu.data import insect as jax_insect

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_insect.InsectLoader, "_tokenize_labels",
                   jax_longest_tokenizer(vocab))
        return jax_insect.InsectLoader(jax_args, split, **kw)


def assert_batches_equal(port, ref):
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert set(a) == set(b)
        for key in b:
            if key == "image":
                assert a[key].dtype == b[key].dtype == np.float32
                np.testing.assert_allclose(a[key], b[key], atol=1e-6)
            elif key == "language":
                for k in b[key]:
                    np.testing.assert_array_equal(a[key][k], b[key][k])
            elif isinstance(b[key], np.ndarray):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert a[key] == b[key], key


def test_load_insect_mat_matches_jax(insect):
    from bioscan_clip_tpu.data.insect import load_insect_mat as jax_mat
    from bioscan_clip_tpu_torch.data.insect import load_insect_mat

    jax_args, _, _ = insect
    ins = jax_args.cfg.insect_data
    for split in ("train_loc", "test_unseen_loc", "all"):
        got = load_insect_mat(ins.path_to_att_splits_mat,
                              ins.path_to_res_101_mat, split)
        assert got == jax_mat(ins.path_to_att_splits_mat,
                              ins.path_to_res_101_mat, split)
    ids, _, _ = load_insect_mat(ins.path_to_att_splits_mat,
                                ins.path_to_res_101_mat, "test_seen_loc")
    assert ids == ["IMG0018", "IMG0019", "IMG0020"]  # 1-based 19..21


@pytest.mark.parametrize("split,eval_parity", [
    ("val_loc", True), ("test_unseen_loc", True), ("all", False),
    ("trainval_loc", False)])
def test_eval_loaders_match_jax(insect, split, eval_parity):
    """Eval batches, float (host eval-parity) or uint8 frames of mixed
    sizes resized to the first frame's shape."""
    from bioscan_clip_tpu_torch.data.insect import InsectLoader

    jax_args, port_args, vocab = insect
    ref = list(jax_loader(jax_args, vocab, split, eval_parity=eval_parity))
    port = InsectLoader(port_args, split, eval_parity=eval_parity,
                        vocab_path=vocab)
    got = list(port)
    assert_batches_equal(got, ref)
    assert len(got) == -(-port.n // 6)
    if eval_parity:
        assert got[0]["image"].shape[1:] == (224, 224, 3)
    else:
        # the first frames of the batches differ in shape
        assert len({b["image_u8"].shape for b in got}) > 1
    assert got[0]["language"]["input_ids"].shape[1] < 20  # longest, not 20


@pytest.mark.parametrize("process_index", [0, 1])
def test_train_loader_matches_jax(insect, process_index):
    """Shuffled train batches (instance labels) over two epochs, as
    process `process_index` of 2."""
    from bioscan_clip_tpu_torch.data.insect import InsectLoader

    jax_args, port_args, vocab = insect
    kw = dict(for_training=True, shuffle=True, batch_size=4,
              process_index=process_index, process_count=2)
    ref_loader = jax_loader(jax_args, vocab, "trainval_loc", **kw)
    port = InsectLoader(port_args, "trainval_loc", vocab_path=vocab, **kw)
    for epoch in range(2):
        got, ref = list(port), list(ref_loader)
        assert_batches_equal(got, ref)
        assert port.epoch == ref_loader.epoch == epoch + 1
        assert len(got) == 2  # 18 rows, 9 per process, 2 full batches of 4
        assert {"image_u8", "labels"} <= set(got[0])
        assert [port.label_dicts[int(i)]["species"]
                for i in got[0]["labels"]] == [
            port.species[int(i)] for i in got[0]["labels"]]


def test_label_tokens_need_a_tokenizer(insect, monkeypatch):
    """No vocab and no cached HF tokenizer: the port raises, where JAX
    falls back to salted hash() ids."""
    from bioscan_clip_tpu_torch.data.insect import InsectLoader

    _, port_args, _ = insect
    monkeypatch.delenv("BSCAN_BERT_VOCAB", raising=False)
    monkeypatch.delenv("BIOSCAN_CLIP_TPU_ALLOW_DOWNLOAD", raising=False)
    with pytest.raises(RuntimeError, match="BSCAN_BERT_VOCAB"):
        InsectLoader(port_args, "val_loc")


@pytest.fixture
def cli_args(insect, monkeypatch, tmp_path):
    """Port args for the CLIs: tiny towers in `load_clip_model`, the vocab
    through $BSCAN_BERT_VOCAB, a fresh project root."""
    import bioscan_clip_tpu_torch.models.clip as port_clip
    from test_torch_train_cl import tiny_factory

    _, port_args, vocab = insect
    monkeypatch.setattr(port_clip, "load_clip_model", tiny_factory)
    monkeypatch.setenv("BSCAN_BERT_VOCAB", vocab)
    monkeypatch.chdir(tmp_path)
    args = port_args.__class__(dict(port_args))
    args["project_root_path"] = str(tmp_path)
    return args


def test_extract_and_bzsl_eval_cli_match_jax(insect, cli_args):
    """Extraction at batch 200 into the BZSL CSVs, then BZSL on them: the
    port's results JSON equals JAX's on the same CSVs, with and without
    tuning."""
    from bioscan_clip_tpu.cli import bzsl_eval as jax_bzsl
    from bioscan_clip_tpu_torch.cli import (
        bzsl_eval,
        extract_feature_for_insect_dataset as extract,
    )

    jax_args, _, _ = insect
    lines = []
    dna_path, img_path = extract.run(cli_args, out=lines.append,
                                     device="cpu")
    assert cli_args.model_config.batch_size == 200
    dna = np.loadtxt(dna_path, delimiter=",")
    img = np.loadtxt(img_path, delimiter=",")
    assert dna.shape == (32, 4) and img.shape == (32, 24)
    assert np.isfinite(dna).all() and np.isfinite(img).all()
    folder = os.path.dirname(dna_path)
    assert folder.endswith(os.path.join("extracted_embedding", "INSECT"))
    for tuning in (False, True):
        res = bzsl_eval.run(cli_args, embeddings_dir=folder, tuning=tuning,
                            out=lines.append)
        with open(os.path.join(folder, "bzsl_results.json")) as f:
            port_json = json.load(f)
        ref = jax_bzsl.run(jax_args, embeddings_dir=folder, tuning=tuning,
                           out=lines.append)
        with open(os.path.join(folder, "bzsl_results.json")) as f:
            assert json.load(f) == port_json
        assert res == ref
        assert all(np.isfinite(v) for v in res.values())


def test_fine_tune_vitb_cli(cli_args, monkeypatch):
    """The full ViT fine-tune (every weight trainable) on uint8 trainval
    frames, eval, and the pre-head feature CSV of every record."""
    from bioscan_clip_tpu_torch.cli import fine_tune_vitb_on_insect as ft
    from bioscan_clip_tpu_torch.models.clip import init_weights
    from bioscan_clip_tpu_torch.models.heads import EncoderWithHead
    from bioscan_clip_tpu_torch.models.vit import ViT, ViTConfig

    built = {}

    def tiny(mc, n_classes, device, dtype):
        vit = ViT(ViTConfig(image_size=224, patch_size=32, hidden_size=32,
                            num_layers=1, num_heads=2,
                            num_classes=mc.output_dim, lora_rank=0), dtype)
        clf = init_weights(EncoderWithHead(vit, mc.output_dim, n_classes,
                                           dtype).to(device))
        built["init"] = {n: p.detach().clone()
                         for n, p in clf.named_parameters()}
        return clf

    monkeypatch.setattr(ft, "build_classifier", tiny)
    lines = []
    state = ft.run(cli_args, out=lines.append, device="cpu")
    assert state.step == 3  # 18 trainval rows at batch 6
    assert any(ln.startswith("Evaluation Result: {'top1_accuracy'")
               for ln in lines)
    loss = float(next(ln for ln in lines if ln.startswith("epoch 0"))
                 .split()[-1])
    assert np.isfinite(loss)
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p, built["init"][n])]
    assert not still, still
    path = next(ln for ln in lines if ".csv" in ln).split()[0]
    assert np.loadtxt(path, delimiter=",").shape == (32, 24)


def test_supervised_fine_tune_cli(cli_args):
    """The joint fine-tune: both heads and towers trained (dropout 0.1 in
    the DNA tower), eval, the heads saved, the BZSL CSVs of the fine-tuned
    towers."""
    from bioscan_clip_tpu_torch.cli import (
        supervised_fine_tune_bioscan_clip_model_on_insect as sft,
    )

    lines = []
    state = sft.run(cli_args, out=lines.append, device="cpu")
    assert state.step == 3
    assert set(state.model) == {"image", "dna"}
    assert any(ln.startswith("Image Evaluation Result") for ln in lines)
    assert any(ln.startswith("DNA Evaluation Result") for ln in lines)
    csvs = [ln.split()[0] for ln in lines if ".csv" in ln]
    shapes = sorted(np.loadtxt(p, delimiter=",").shape for p in csvs)
    assert shapes == [(32, 4), (32, 24)]
    runs = os.path.join(cli_args.project_root_path, "ckpt",
                        "supervised_fine_tune_bioscan_clip_model_on_insect")
    (stamp,) = os.listdir(runs)
    assert "joint_last" in os.listdir(os.path.join(runs, stamp))
