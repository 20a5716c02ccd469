"""The INSECT dataset (.mat-driven): the zero-shot transfer corpus.

A copy of bioscan_clip_tpu/data/insect.py on the port's loader machinery:
- `att_splits.mat` holds 1-based split index vectors (`train_loc`,
  `val_loc`, `test_seen_loc`, `test_unseen_loc`, `trainval_loc`);
  `res101.mat` holds `ids`, `nucleotides`, `species` (`load_insect_mat`);
- species -> {order, family, genus} comes from a JSON side table
  (`specie_to_other_labels.json`), a missing level is 'not_classified';
- the label string is "order family genus species", tokenized with
  BERT-small padded to the longest string of the split
  (`data/tokenizers.tokenize_labels_longest`). Unlike the JAX loader, which
  falls back to `hash()` ids that change from process to process when no
  tokenizer loads, this raises;
- images live in a per-id HDF5 (`INSECT_images.hdf5`, group 'images');
  opened by the port's `data/h5file.py` when the first batch is read;
- eval batches carry host eval-parity float images under "image"
  (`eval_parity`, the default), or uint8 frames resized to shorter side 256
  under "image_u8", a frame of another shape resized with cv2 to the
  first frame's (JAX insect.py:233-245);
- train batches carry instance labels (row indices into the split: map
  them back with `loader.label_dicts[l]`), shuffled per epoch from seed +
  epoch, the process-strided shard of each epoch's order; the INSECT train
  augmentation's ColorJitter runs on the device (`cli/train_cl.py`).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from bioscan_clip_tpu_torch.data.pipeline import PrefetchLoader
from bioscan_clip_tpu_torch.data.tokenizers import (
    tokenize_dna_batch,
    tokenize_labels_longest,
)
from bioscan_clip_tpu_torch.data.transforms import (
    decode_jpeg,
    host_eval_image,
    host_resize_shorter,
)

LEVELS = ["order", "family", "genus"]


def species_list_to_input_string_list(species_list, species_to_others):
    out = []
    for sp in species_list:
        info = species_to_others.get(sp, {})
        parts = [info.get(level, "not_classified") for level in LEVELS]
        out.append(" ".join(parts) + " " + sp)
    return out


def species_list_to_labels(species_list, species_to_others):
    out = []
    for sp in species_list:
        info = species_to_others.get(sp, {})
        out.append({level: info.get(level, "not_classified")
                    for level in LEVELS} | {"species": sp})
    return out


def load_insect_mat(path_to_att_splits_mat, path_to_res_101_mat, split):
    """(image_ids, barcodes, species) of one split ('all': every record)."""
    import scipy.io as sio

    res = sio.loadmat(path_to_res_101_mat)
    image_ids = [x.item() for x in res["ids"].flatten()]
    barcodes = [x.item() for x in res["nucleotides"].flatten()]
    species = [x.item() for x in res["species"].flatten()]
    if split != "all":
        loc = sio.loadmat(path_to_att_splits_mat)[split][0]
        image_ids = [image_ids[i - 1] for i in loc]  # 1-based indices
        barcodes = [barcodes[i - 1] for i in loc]
        species = [species[i - 1] for i in loc]
    return image_ids, barcodes, species


class InsectLoader(PrefetchLoader):
    """Batch dicts over one INSECT split, in `BioscanLoader`'s contract:
    image or image_u8, dna (B, 133) int32, language {input_ids,
    token_type_ids, attention_mask} (B, L) int32, then labels (training)
    or label_dicts and ids (eval). `vocab_path`: the BERT-small vocab.txt
    of the label tokenizer (default $BSCAN_BERT_VOCAB, else the cached HF
    tokenizer)."""

    def __init__(self, args, split: str, *, for_training: bool = False,
                 shuffle: bool = False, batch_size: Optional[int] = None,
                 seed: int = 0, decode_threads: int = 16,
                 prefetch_depth: int = 2, host_resize_to: int = 256,
                 eval_parity: bool = True, openclip_norm: bool = False,
                 process_index: int = 0, process_count: int = 1,
                 vocab_path: Optional[str] = None):
        ins = args.insect_data
        with open(ins.species_to_other) as f:
            self.species_to_others = json.load(f)
        self.image_ids, barcodes, self.species = load_insect_mat(
            ins.path_to_att_splits_mat, ins.path_to_res_101_mat, split)
        self.image_hdf5_path = ins.path_to_image_hdf5
        self.split = split
        self.batch_size = batch_size or args.model_config.batch_size
        self.for_training = for_training
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.decode_threads = decode_threads
        self.prefetch_depth = prefetch_depth
        self.host_resize_to = host_resize_to
        tpu_cfg = getattr(args, "tpu", None)
        if tpu_cfg is not None:
            eval_parity = bool(tpu_cfg.get("eval_host_parity_resize",
                                           eval_parity))
        self.eval_parity = eval_parity and not for_training
        self.openclip_norm = openclip_norm or bool(
            getattr(args.model_config, "for_open_clip", False))
        self.process_index = process_index
        self.process_count = process_count
        self.n = len(self.image_ids)
        self._images = None

        self.dna_tokens = tokenize_dna_batch(barcodes)
        self.language = tokenize_labels_longest(
            species_list_to_input_string_list(self.species,
                                              self.species_to_others),
            vocab_path=vocab_path)
        self.label_dicts = species_list_to_labels(self.species,
                                                  self.species_to_others)
        self.labels = np.arange(self.n, dtype=np.int64)

    def _open_images(self):
        if self._images is None:
            from bioscan_clip_tpu_torch.data import h5file

            self._images = h5file.File(self.image_hdf5_path, "r")["images"]
        return self._images

    def __len__(self):
        if self.for_training:
            return (self.n // self.process_count) // self.batch_size
        return -(-self.n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(
                idx)
        if self.process_count > 1 and self.for_training:
            idx = idx[self.process_index::self.process_count]
        bs = self.batch_size
        n_full = len(idx) // bs
        for b in range(n_full):
            yield idx[b * bs:(b + 1) * bs]
        if not self.for_training and n_full * bs < len(idx):
            yield idx[n_full * bs:]

    def _decode(self, i):
        g = self._open_images()
        return decode_jpeg(np.asarray(g[self.image_ids[i]]).tobytes())

    def _make_batch(self, idx, pool) -> dict:
        if self.eval_parity:
            image_key, image = "image", np.stack(list(pool.map(
                lambda i: host_eval_image(self._decode(i),
                                          normalize=self.openclip_norm),
                idx.tolist())))
        else:
            def load_one(i):
                im = self._decode(i)
                if self.host_resize_to:
                    im = host_resize_shorter(im, self.host_resize_to)
                return im

            imgs = list(pool.map(load_one, idx.tolist()))
            if len({im.shape for im in imgs}) > 1:
                import cv2

                h0, w0 = imgs[0].shape[:2]
                imgs = [im if im.shape[:2] == (h0, w0)
                        else cv2.resize(im, (w0, h0)) for im in imgs]
            image_key, image = "image_u8", np.stack(imgs).astype(np.uint8)
        batch = {
            image_key: image,
            "dna": self.dna_tokens[idx],
            "language": {k: v[idx] for k, v in self.language.items()},
        }
        if self.for_training:
            batch["labels"] = self.labels[idx]
        else:
            batch["label_dicts"] = [self.label_dicts[i] for i in idx]
            batch["ids"] = [self.image_ids[i] for i in idx]
        return batch


def load_insect_dataloader(args, world_size=None, rank=None, num_workers=8,
                           load_all_in_one=False,
                           shuffle_for_train_seen_key=False,
                           process_index: int = 0, process_count: int = 1):
    """(train, train_for_key, val, test_seen, test_unseen), or the one
    loader over every record with `load_all_in_one`
    (dataset_for_insect_dataset.py:193-267). Only the train loader is
    process-sharded: every process evaluates the full splits."""
    if load_all_in_one:
        return InsectLoader(args, "all")
    train = InsectLoader(args, "train_loc", for_training=True, shuffle=True,
                         process_index=process_index,
                         process_count=process_count)
    train_for_key = InsectLoader(args, "train_loc",
                                 shuffle=shuffle_for_train_seen_key)
    return (train, train_for_key, InsectLoader(args, "val_loc"),
            InsectLoader(args, "test_seen_loc"),
            InsectLoader(args, "test_unseen_loc"))


def load_insect_dataloader_trainval(args, num_workers=8,
                                    shuffle_for_train_seen_key=False):
    """The shuffled train loader over `trainval_loc` (the fine-tunes')."""
    return InsectLoader(args, "trainval_loc", for_training=True,
                        shuffle=True)
