"""BIOSCAN split generator (the reference's dataset/create_splits.py).

A copy of bioscan_clip_tpu/data/splits.py (`create_splits` and its helpers
:24-188), with the same seeded draws and leakage assertions. pandas is
imported inside the functions that need it (the card's machine has none).

Split design (create_splits.py:1-14):
  all -> filter not_classified species
  species with >= min_species_size samples:
    species -> seen (0.8) / unseen (0.2)
    seen species samples -> train/val/test/query 0.7/0.1/0.1/0.1
    unseen species -> val/test halves, each -> record/query halves
  tail species (2..min-1 samples) -> merged into the unseen val/test splits
  singleton species -> 'single_species' (pretraining only)

    python -m bioscan_clip_tpu_torch.data.splits --metadata META.tsv \
        -o SPLITS.tsv [-s 10] [-r 0.8] [-e 0.7 0.1 0.1 0.1] [-u 0.5] [-x SEED]
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

TAIL_THRESHOLD = 10


def filter_no_species(metadata):
    return metadata[metadata["species"] != "not_classified"]


def get_tail_species(metadata, threshold: int = TAIL_THRESHOLD):
    counts = metadata.groupby("species").size()
    return counts.index[counts < threshold]


def create_split_boundaries(size: int, split_ratios) -> list:
    assert sum(split_ratios) == 1
    sizes = [int(r * size) for r in split_ratios]
    bounds = []
    for s in sizes[:-1]:
        bounds.append(s if not bounds else s + bounds[-1])
    return bounds


def split_species(metadata, split_ratios=0.8, seed=None):
    """Partition by species identity (create_splits.py:45-53)."""
    import pandas as pd

    if isinstance(split_ratios, float):
        split_ratios = [split_ratios, 1 - split_ratios]
    assert sum(split_ratios) == 1
    all_species = pd.unique(metadata["species"])
    rng = np.random.default_rng(seed=seed)
    bounds = create_split_boundaries(len(all_species), split_ratios)
    groups = np.split(rng.permutation(all_species), bounds)
    return [metadata[metadata["species"].isin(g)] for g in groups]


def split_samples_per_species(metadata, split_ratios, seed=None):
    """Per-species record partition (create_splits.py:56-75)."""
    import pandas as pd

    if isinstance(split_ratios, float):
        split_ratios = [split_ratios, 1 - split_ratios]
    split_ratios = [Decimal(str(f)) for f in split_ratios]
    assert sum(split_ratios) == 1
    metadata = metadata.reset_index()
    rng = np.random.default_rng(seed=seed)
    assignments = [[] for _ in split_ratios]
    for species in pd.unique(metadata["species"]):
        idx = metadata[metadata["species"] == species].index.to_numpy()
        bounds = create_split_boundaries(idx.shape[0], split_ratios)
        for i, part in enumerate(np.split(rng.permutation(idx), bounds)):
            assignments[i].append(part)
    return [
        metadata.loc[np.concatenate(parts)].set_index("index")
        for parts in assignments
    ]


def assert_no_overlap(source, targets, assume_unique=True):
    for target in targets:
        if len(np.intersect1d(source, target, assume_unique=assume_unique)):
            raise ValueError("Found overlap in splits.")


def create_final_metadata(metadata, **splits):
    cols = [c for c in ("sampleid", "uri", "image_file", "species")
            if c in metadata.columns]
    out = metadata[cols].copy()
    out["split"] = "no_split"
    for name, split in splits.items():
        out.loc[out["sampleid"].isin(split["sampleid"]), "split"] = name
    return out


def create_splits(
    metadata,
    min_species_size: int = TAIL_THRESHOLD,
    seen_ratio: float = 0.8,
    seen_splits=(0.7, 0.1, 0.1, 0.1),
    percent_unseen_val: float = 0.5,
    seed=None,
):
    """Full pipeline (create_splits.py:93-167). Returns the split metadata
    table (sampleid/uri/image_file/species/split)."""
    import pandas as pd

    species_md = filter_no_species(metadata)

    tail = get_tail_species(species_md, threshold=min_species_size)
    tail_md = species_md[species_md["species"].isin(tail)]
    common_md = species_md[~species_md["species"].isin(tail)]

    seen_sp, unseen_sp = split_species(common_md, seen_ratio, seed=seed)
    train_seen, val_seen, test_seen, seen_query = split_samples_per_species(
        seen_sp, list(seen_splits), seed=seed
    )

    val_unseen, test_unseen = split_species(
        unseen_sp, percent_unseen_val, seed=seed
    )
    val_unseen, val_unseen_q = split_samples_per_species(
        val_unseen, percent_unseen_val, seed=seed
    )
    test_unseen, test_unseen_q = split_samples_per_species(
        test_unseen, percent_unseen_val, seed=seed
    )

    singles = get_tail_species(tail_md, threshold=2)
    single_species = tail_md[tail_md["species"].isin(singles)]
    tail_md = tail_md[~tail_md["species"].isin(singles)]
    if len(tail_md):
        t_val, t_test = split_species(tail_md, 0.5, seed=seed)
        if len(t_val):
            t_val, t_val_q = split_samples_per_species(t_val, 0.5, seed=seed)
            val_unseen = pd.concat([val_unseen, t_val])
            val_unseen_q = pd.concat([val_unseen_q, t_val_q])
        if len(t_test):
            t_test, t_test_q = split_samples_per_species(
                t_test, 0.5, seed=seed
            )
            test_unseen = pd.concat([test_unseen, t_test])
            test_unseen_q = pd.concat([test_unseen_q, t_test_q])

    # leakage validation (create_splits.py:137-148)
    tr_sp = pd.unique(train_seen["species"])
    v_sp = pd.unique(val_seen["species"])
    te_sp = pd.unique(test_seen["species"])
    vu_sp = pd.unique(val_unseen["species"])
    tu_sp = pd.unique(test_unseen["species"])
    assert_no_overlap(vu_sp, [tr_sp, v_sp, te_sp, tu_sp])
    assert_no_overlap(tu_sp, [tr_sp, v_sp, te_sp])
    assert_no_overlap(
        train_seen["sampleid"], [val_seen["sampleid"], test_seen["sampleid"]]
    )
    assert_no_overlap(val_seen["sampleid"], [test_seen["sampleid"]])

    return create_final_metadata(
        metadata,
        train_seen=train_seen,
        val_seen=val_seen,
        val_unseen=val_unseen,
        test_seen=test_seen,
        test_unseen=test_unseen,
        query_seen=seen_query,
        val_query_unseen=val_unseen_q,
        test_query_unseen=test_unseen_q,
        single_species=single_species,
    )


def main(argv=None):
    import argparse

    import pandas as pd

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--metadata", required=True)
    p.add_argument("-s", "--min-species-size", type=int, default=TAIL_THRESHOLD)
    p.add_argument("-r", "--seen-ratio", type=float, default=0.8)
    p.add_argument("-e", "--seen-splits", type=float, nargs=4,
                   default=[0.7, 0.1, 0.1, 0.1])
    p.add_argument("-u", "--unseen-splits", type=float, default=0.5)
    p.add_argument("-x", "--seed", type=int, default=None)
    p.add_argument("-o", "--output", required=True)
    a = p.parse_args(argv)
    md = pd.read_csv(a.metadata, sep="\t")
    out = create_splits(
        md, a.min_species_size, a.seen_ratio, a.seen_splits,
        a.unseen_splits, a.seed,
    )
    out.to_csv(a.output, sep="\t")
    print(out["split"].value_counts())
    return out


if __name__ == "__main__":
    main()
