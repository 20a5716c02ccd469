"""Flatten a BIOSCAN-CLIP results.csv to one metric per row.

A copy of bioscan_clip_tpu/cli/flatten_csv.py (the reference's
scripts/flattenCsv.py, :21-59): the Metric column splits into micro_macro
and top_k, and each Seen_*/Unseen_* column into seen_unseen, taxon and
value rows. Standard library only.

    python -m bioscan_clip_tpu_torch.cli.flatten_csv -i results.csv [-o OUT]
"""

from __future__ import annotations

import argparse
import csv
import sys

METRIC_VALUE_COLUMNS = [
    "Seen_Order", "Seen_Family", "Seen_Genus", "Seen_Species",
    "Unseen_Order", "Unseen_Family", "Unseen_Genus", "Unseen_Species",
]
METRIC_NAME_COLUMN = "Metric"


def flatten(rows, fieldnames):
    """(rows, fieldnames) of results.csv -> (one row per (metric, value
    column), the output's fieldnames)."""
    ignore = set(METRIC_VALUE_COLUMNS) | {METRIC_NAME_COLUMN}
    keep = [f for f in fieldnames if f not in ignore]
    out_fields = keep + ["micro_macro", "top_k", "seen_unseen", "taxon", "value"]
    out_rows = []
    for row in rows:
        base = {k: v for k, v in row.items() if k in keep}
        parts = row[METRIC_NAME_COLUMN].split("_")
        base["micro_macro"] = parts[0]
        base["top_k"] = parts[1].replace("Top-", "")
        for col in METRIC_VALUE_COLUMNS:
            r = dict(base)
            su, taxon = col.split("_")
            r["seen_unseen"] = su
            r["taxon"] = taxon
            r["value"] = row[col]
            out_rows.append(r)
    return out_rows, out_fields


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", type=argparse.FileType("w"),
                   default=sys.stdout)
    a = p.parse_args(argv)
    delim = "\t" if a.input.endswith(".tsv") else ","
    with open(a.input) as f:
        reader = csv.DictReader(f, delimiter=delim)
        rows = list(reader)
        fieldnames = reader.fieldnames
    out_rows, out_fields = flatten(rows, fieldnames)
    writer = csv.DictWriter(a.output, fieldnames=out_fields)
    writer.writeheader()
    writer.writerows(out_rows)


if __name__ == "__main__":
    main()
