"""Data-loading throughput probe: the train loader with the model math off.

Counterpart of bioscan_clip_tpu/cli/loading_speed_test.py (the reference's
bioscanclip/epoch/special_epoch_for_loading_speed_test.py :13-42): iterate
the pre-training loader of `data/dataset.load_dataloader` through its
prefetch thread and report samples/s on the host. Besides, for each of the
four loaders, the decode path it takes (the host's libjpeg pool once built,
`data/native_io.build()`, or Python), and for the train loader the host ms
per batch of each stage, run synchronously on its first batches: the HDF5
read of the JPEG bytes, their decode, and the whole batch (read, decode,
resize or augmentation, DNA tokens, labels).

    python -m bioscan_clip_tpu_torch.cli.loading_speed_test \
        'model_config=NAME' [key=value config overrides]
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LOADERS = ("pre_train", "val_seen", "val_unseen", "all_keys")


def decode_path(loader) -> str:
    """The path `loader` decodes by, after its first image decides whether
    the pool applies (it drops the pool below `host_resize_to`)."""
    if not loader.with_image:
        return "none (no image modality)"
    if loader.eval_parity:
        return "python (cv2/PIL), host eval transform"
    if loader.use_native and loader.n:
        loader._native_out_hw(loader.reader.read_images_bytes([0])[0])
    return ("native (libbscan_io)" if loader.use_native
            else "python (cv2/PIL)")


def stage_ms(loader, batches: int = 3) -> dict:
    """Median host ms per batch of each stage over the loader's first
    `batches` batches, run on this thread."""
    from bioscan_clip_tpu_torch.data.transforms import decode_jpeg

    times = {"read_ms": [], "decode_ms": [], "batch_ms": []}
    with ThreadPoolExecutor(max_workers=loader.decode_threads) as pool:
        for idx, _ in zip(loader._index_batches(), range(batches)):
            t0 = time.perf_counter()
            bufs = loader.reader.read_images_bytes(idx)
            t1 = time.perf_counter()
            if loader._native_frames(bufs) is None:
                list(pool.map(decode_jpeg, bufs))
            t2 = time.perf_counter()
            loader._make_batch(idx, pool)
            t3 = time.perf_counter()
            for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
                times[k].append(1e3 * dt)
    return {k: float(np.median(v)) for k, v in times.items() if v}


def run(args, max_batches: int = 50, out=print) -> dict:
    """Iterate up to `max_batches` train batches; returns samples/s, the
    samples counted, the stage times and each loader's decode path."""
    from bioscan_clip_tpu_torch.data.dataset import load_dataloader

    loaders = load_dataloader(args)
    paths = {name: decode_path(ld) for name, ld in zip(LOADERS, loaders)}
    for name, path in paths.items():
        out(f"{name}: decode path {path}")
    pre_train = loaders[0]
    stages = stage_ms(pre_train)
    out("stages (host ms per batch, median): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    n = 0
    t0 = time.perf_counter()
    for i, batch in enumerate(pre_train):
        n += len(batch["labels"])
        if i + 1 >= max_batches:
            break
    dur = time.perf_counter() - t0
    out(f"{n} samples in {dur:.2f}s -> {n / dur:.1f} samples/s (host only)")
    return {"samples_per_s": n / dur, "samples": n, "stages": stages,
            "decode_paths": paths}


def main(argv=None):
    from bioscan_clip_tpu_torch.config.core import load_config

    args = load_config(
        overrides=list(argv if argv is not None else sys.argv[1:])
    )
    return run(args)


if __name__ == "__main__":
    main()
