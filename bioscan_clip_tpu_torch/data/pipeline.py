"""Host data pipeline: HDF5 rows -> batch dicts, for eval and training.

A copy of bioscan_clip_tpu/data/pipeline.py (`_fit_to_slot`,
`BioscanLoader` :64-441): chunked sorted-index HDF5 reads, streamed DNA
tokenization per batch, threaded JPEG decode on the host, and a background
prefetch thread keeping `prefetch_depth` batches ready, cancelled when the
consumer stops iterating early.

Images come out in one of four forms, as in JAX:
- `eval_parity=True` (default, eval splits only): the torchvision-exact
  host eval transform, (B, 224, 224, 3) float32 under "image";
- `train_crop=True` (train splits only): `host_train_augment`, the whole
  geometric augmentation on the host, (B, 224, 224, 3) uint8 under
  "image_u8", each image on its own numpy stream spawned from (seed,
  epoch, first index of the batch);
- otherwise (B, H, W, 3) uint8 under "image_u8", each frame resized on the
  host to shorter side 256 (cv2) and fitted to the first frame's slot, for
  the device eval transform;
- with `eval_host_crop` as well, that frame's (224, 224) center crop
  (`eval_pre_cropped`), which the device only casts.

Decoding is Python (cv2, else PIL) in a thread pool. The JAX package's
native libjpeg decode pool (`data/native_io.py`) is not ported
(`ROADMAP.md` queue 1, item 5): this loader never looks for it.

`for_training=True` gives train batches: "labels" (instance ids, or the
BIN labels passed in) instead of label dicts and ids, `drop_last` by
default, a shuffle per epoch from `seed` + epoch (within windows of
`shuffle_window` rows when it is set), and the `process_index`-strided
shard of every epoch's order. The epoch advances after each complete pass;
`set_epoch` sets it, as a run that stops epochs early or resumes must.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from bioscan_clip_tpu_torch.data.hdf5 import SplitReader
from bioscan_clip_tpu_torch.data.transforms import (
    decode_jpeg,
    host_eval_image,
    host_resize_shorter,
    host_train_augment,
)


def fit_to_slot(im: np.ndarray, h0: int, w0: int) -> np.ndarray:
    """Fit (h, w, 3) into a fixed (h0, w0) slot: center crop if larger,
    edge-replicate pad if smaller."""
    h, w = im.shape[:2]
    if h > h0:
        top = (h - h0) // 2
        im = im[top : top + h0]
    if w > w0:
        left = (w - w0) // 2
        im = im[:, left : left + w0]
    h, w = im.shape[:2]
    if h < h0 or w < w0:
        pt = (h0 - h) // 2
        pl = (w0 - w) // 2
        im = np.pad(
            im, ((pt, h0 - h - pt), (pl, w0 - w - pl), (0, 0)), mode="edge"
        )
    return im


class PrefetchLoader:
    """The iteration of a host loader: `_index_batches()` yields each
    batch's row indices, `_make_batch(idx, pool)` builds its dict on a
    background thread with a decode pool of `decode_threads`, keeping
    `prefetch_depth` batches ready. A train loader's epoch advances after
    each complete pass. Subclasses set `decode_threads`,
    `prefetch_depth`, `for_training` and `epoch`."""

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        stop = object()
        # a consumer that abandons iteration mid-epoch closes this
        # generator; `cancel` then unblocks and ends the producer
        cancel = threading.Event()

        def _put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(
                        max_workers=self.decode_threads) as pool:
                    for idx in self._index_batches():
                        if cancel.is_set() or not _put(
                                self._make_batch(idx, pool)):
                            return
            except BaseException as e:  # surface errors to the consumer
                _put(e)
            finally:
                # a full queue does not mean the consumer is gone: retry
                # until it takes `stop` or cancels
                _put(stop)

        t = threading.Thread(
            target=producer, daemon=True, name="bscan-prefetch"
        )
        t.start()
        completed = False
        try:
            while True:
                item = q.get()
                if item is stop:
                    completed = True
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancel.set()
            if not completed:
                # unblock a producer stuck on a full queue, then let it
                # observe `cancel` and exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
            t.join(timeout=30.0)
        if self.for_training:
            self.epoch += 1


class BioscanLoader(PrefetchLoader):
    """Iterable over batch dicts of one split.

    Batch dict keys (modalities follow model_config):
      image:    (B, 224, 224, 3) float32, host eval transform (parity path)
      image_u8: (B, H, W, 3) uint8 (the device transform's input)
      dna:      (B, 133) int32 k-mer tokens
      language: {input_ids, token_type_ids, attention_mask} (B, 20) int32
      labels:   (B,) int64 instance or BIN ids (training)
      label_dicts: host list of 4-level dicts (eval)
      ids:      host list of processid/image_file strings (eval)
    """

    def __init__(
        self,
        hdf5_path: str,
        split: str,
        batch_size: int,
        *,
        with_image: bool = True,
        with_dna: bool = True,
        with_language: bool = True,
        for_training: bool = False,
        shuffle: bool = False,
        seed: int = 0,
        decode_threads: int = 16,
        prefetch_depth: int = 2,
        host_resize_to: int = 256,
        eval_parity: bool = True,
        eval_host_crop: bool = False,
        eval_crop_size: int = 224,
        openclip_norm: bool = False,
        process_index: int = 0,
        process_count: int = 1,
        shuffle_window: int = 0,
        drop_last: Optional[bool] = None,
        labels: Optional[np.ndarray] = None,
        train_crop: bool = False,
        train_crop_size: int = 224,
    ):
        self.reader = SplitReader(hdf5_path, split)
        self.split = split
        self.batch_size = batch_size
        self.with_image = with_image
        self.with_dna = with_dna
        self.with_language = with_language
        self.for_training = for_training
        self.shuffle = shuffle
        self.shuffle_window = int(shuffle_window)
        self.drop_last = for_training if drop_last is None else drop_last
        self.seed = seed
        self.epoch = 0
        self.decode_threads = decode_threads
        self.prefetch_depth = prefetch_depth
        self.host_resize_to = host_resize_to
        self.eval_parity = eval_parity and not for_training
        # host CenterCrop(224) of the shorter-side-256 uint8 frame for the
        # non-parity path: an exact slice, so the device sees the pixels it
        # would crop itself while the feed carries ~2x fewer bytes
        self.eval_pre_cropped = (
            eval_host_crop and with_image and not for_training
            and not self.eval_parity
        )
        # the host Resize + RandomResizedCrop + flips + rotation of train
        # frames: (224, 224, 3) uint8, half the bytes of the 256-side frame
        self.train_crop = train_crop and for_training
        self.train_crop_size = train_crop_size
        self.eval_crop_size = eval_crop_size
        self.openclip_norm = openclip_norm
        self.process_index = process_index
        self.process_count = process_count
        self.n = len(self.reader)
        # instance labels for contrastive training (reference dataset.py:147)
        # unless BIN labels were passed in
        self.labels = labels
        if for_training and labels is None:
            self.labels = np.arange(self.n, dtype=np.int64)

    def __len__(self):
        if self.drop_last:
            return (self.n // self.process_count) // self.batch_size
        return -(-self.n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            w = self.shuffle_window
            if w and w < self.n:
                # permute rows within each contiguous window, then the
                # window order: disk-local reads at 1/w of the randomness
                n_win = -(-self.n // w)
                parts = []
                for win in rng.permutation(n_win):
                    lo = win * w
                    hi = min(lo + w, self.n)
                    parts.append(lo + rng.permutation(hi - lo))
                idx = np.concatenate(parts)
            else:
                idx = rng.permutation(idx)
        if self.process_count > 1:
            idx = idx[self.process_index :: self.process_count]
        bs = self.batch_size
        n_full = len(idx) // bs
        for b in range(n_full):
            yield idx[b * bs : (b + 1) * bs]
        if not self.drop_last and n_full * bs < len(idx):
            yield idx[n_full * bs :]

    def _make_batch(self, idx, pool) -> dict:
        batch = {}
        if self.with_image:
            bufs = self.reader.read_images_bytes(idx)
            imgs = list(pool.map(decode_jpeg, bufs))
            if self.eval_parity:
                batch["image"] = np.stack(list(pool.map(
                    lambda im: host_eval_image(
                        im, normalize=self.openclip_norm),
                    imgs)))
            elif self.train_crop:
                # independent per-image streams, deterministic in
                # (seed, epoch, first index of the batch)
                rngs = np.random.default_rng(
                    [self.seed, self.epoch, int(idx[0])]).spawn(len(imgs))
                batch["image_u8"] = np.stack(list(pool.map(
                    lambda t: host_train_augment(
                        t[0], t[1], size=self.train_crop_size,
                        resize_to=self.host_resize_to),
                    zip(imgs, rngs))))
            else:
                if self.host_resize_to:
                    imgs = list(pool.map(
                        lambda im: host_resize_shorter(
                            im, self.host_resize_to),
                        imgs))
                if len({im.shape for im in imgs}) > 1:
                    # rare aspect outliers: fit to the first image's slot
                    h0, w0 = imgs[0].shape[:2]
                    imgs = [fit_to_slot(im, h0, w0) for im in imgs]
                if self.eval_pre_cropped:
                    # crop after the slot unification: the same two-stage
                    # geometry as the device center crop
                    s = self.eval_crop_size
                    imgs = [fit_to_slot(im, s, s) for im in imgs]
                batch["image_u8"] = np.stack(imgs).astype(np.uint8)
        if self.with_dna:
            batch["dna"] = self.reader.read_dna_tokens(idx)
        if self.with_language:
            batch["language"] = self.reader.read_language_tokens(idx)
        if self.for_training:
            batch["labels"] = self.labels[idx]
        else:
            batch["label_dicts"] = self.reader.read_label_dicts(idx)
            batch["ids"] = self.reader.read_ids(idx)
        return batch
