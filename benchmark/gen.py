"""The one traffic generator: it reads a traffic mix's parameters (a JSON
file under `traffic/`) and a configuration's, and makes every input from
`--seed` alone. The program gets only what it returns.

- Frames: uint8 (H, W, 3) images of `frame_blocks` flat-coloured blocks,
  each block's colour uniform in 0-255, so every frame has its own
  low-frequency content (i.i.d. pixel noise would embed alike under random
  weights).
- "train" mixes: batches of frames, DNA token ids, text token ids with
  `text_min_tokens` to `text_tokens` real tokens (the rest padding), and
  instance labels. Batch i depends on (seed, i) only.
- "search" mixes: a pool of frames and a closed-loop schedule of requests.
  Each request asks about `plates[j]` plates of `plate_size` specimens.
  The sizes come in rounds that hold each entry of `plates` once, in an
  order drawn from the seed, so every seed offers the same mix of sizes
  in another order. A request's frames are distinct draws from the pool.
- The key database of a configuration's `serve_keys`: unit-norm random
  keys and a four-level taxonomy (species -> genus -> family -> order).
"""

from __future__ import annotations

import numpy as np
import torch

LEVELS = ("order", "family", "genus", "species")


def sub_seed(seed: int, *parts: int) -> int:
    """A generator seed for one part of a run, from --seed and the part's
    indices (a splitmix64-style mix, below 2**63)."""
    x = int(seed) & (2**64 - 1)
    for p in parts:
        x = (x ^ (int(p) + 0x9E3779B97F4A7C15 + (x << 6) + (x >> 2))) \
            & (2**64 - 1)
        x = (x * 0xBF58476D1CE4E5B9) & (2**64 - 1)
        x ^= x >> 31
    return x & (2**63 - 1)


def frames(n: int, tr: dict, gen: torch.Generator, device):
    """(n, H, W, 3) uint8 block frames on `device`."""
    h, w = tr["frame"]
    gh, gw = tr["frame_blocks"]
    grid = torch.randint(0, 256, (n, gh, gw, 3), generator=gen,
                         device=device, dtype=torch.int64).to(torch.uint8)
    return grid.repeat_interleave(h // gh, dim=1).repeat_interleave(
        w // gw, dim=2)


def train_batch(tr: dict, seed: int, index: int, device) -> dict:
    """Batch `index` of a train mix: a dict of tensors on `device`."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1, index))
    b, nt = tr["batch"], tr["text_tokens"]
    lengths = torch.randint(tr["text_min_tokens"], nt + 1, (b, 1),
                            generator=gen, device=device)
    mask = (torch.arange(nt, device=device)[None, :] < lengths).to(
        torch.int64)
    ids = torch.randint(1, tr["text_vocab"], (b, nt), generator=gen,
                        device=device)
    return {
        "image_u8": frames(b, tr, gen, device),
        "dna": torch.randint(0, tr["dna_vocab"], (b, tr["dna_tokens"]),
                             generator=gen, device=device),
        "language": {"input_ids": ids * mask,
                     "token_type_ids": torch.zeros_like(ids),
                     "attention_mask": mask},
        "labels": torch.arange(b, device=device),
    }


def frame_pool(tr: dict, seed: int, device) -> np.ndarray:
    """The search mix's pool of frames, made on `device`, held on the host
    as the client holds its images."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    return frames(tr["frame_pool"], tr, gen, device).cpu().numpy()


def search_schedule(tr: dict, seed: int, count: int):
    """The first `count` requests of a closed-loop search mix: [(plates,
    frame indices into the pool)]."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    plates = list(tr["plates"])
    out = []
    while len(out) < count:
        for j in rng.permutation(len(plates)):
            n = plates[j] * tr["plate_size"]
            out.append((plates[j], rng.choice(tr["frame_pool"], size=n,
                                              replace=False)))
    return out[:count]


def key_database(keys: dict, dim: int, seed: int, device):
    """(keys (N, D) float32 unit rows on `device`, species id of each key
    (N,) int64 on `device`, the label dict of each key). Species s is in
    genus s // (species / genera), and so on up to the order."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    n = keys["count"]
    k = torch.randn(n, dim, generator=gen, device=device)
    k = k / k.norm(dim=-1, keepdim=True)
    species = torch.randint(0, keys["species"], (n,), generator=gen,
                            device=device)
    dicts = [taxonomy(s, keys) for s in range(keys["species"])]
    labels = [dicts[s] for s in species.tolist()]
    return k, species, labels


def taxonomy(s: int, keys: dict) -> dict:
    """The label dict of species s."""
    per = {lvl: keys["species"] // keys[lvl + "_count"]
           for lvl in ("genus", "family", "order")}
    return {"order": f"order{s // per['order']}",
            "family": f"family{s // per['family']}",
            "genus": f"genus{s // per['genus']}",
            "species": f"species{s}"}
