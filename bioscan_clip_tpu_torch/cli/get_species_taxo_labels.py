"""Build specie_to_other_labels.json: species -> {order, family, genus}.

A copy of bioscan_clip_tpu/cli/get_species_taxo_labels.py (the reference's
data/INSECT/get_all_species_taxo_labels_dict_and_save_to_json.py). The
local mode builds the JSON from any TSV/CSV with species/order/family/genus
columns (e.g. the BIOSCAN metadata TSV); the reference's NCBI Entrez mode
needs Biopython and the network, and is kept behind `--ncbi-email` as in
JAX. pandas is imported inside the functions that need it.

    python -m bioscan_clip_tpu_torch.cli.get_species_taxo_labels
        (--taxonomy-table TABLE | --ncbi-email EMAIL)
        [--species-csv INSECT_metadata.csv] [--out specie_to_other_labels.json]
"""

from __future__ import annotations

import argparse
import json


def from_metadata_table(table_path, species_list=None, sep=None):
    """species -> its first row's order/family/genus (column names matched
    case-insensitively), restricted to `species_list` when given."""
    import pandas as pd

    sep = sep or ("\t" if table_path.endswith(".tsv") else ",")
    df = pd.read_csv(table_path, sep=sep)
    cols = {c.lower(): c for c in df.columns}
    out = {}
    for _, row in df.iterrows():
        sp = str(row[cols["species"]])
        if species_list is not None and sp not in species_list:
            continue
        if sp not in out:
            out[sp] = {
                "order": str(row[cols["order"]]),
                "family": str(row[cols["family"]]),
                "genus": str(row[cols["genus"]]),
            }
    return out


def from_ncbi(species_list, email):
    """NCBI Entrez taxonomy lookup (requires network + Biopython)."""
    from Bio import Entrez  # noqa: optional dependency

    Entrez.email = email
    out = {}
    for sp in species_list:
        handle = Entrez.esearch(db="taxonomy", term=sp)
        rec = Entrez.read(handle)
        if not rec["IdList"]:
            out[sp] = {}
            continue
        handle = Entrez.efetch(db="taxonomy", id=rec["IdList"][0],
                               retmode="xml")
        tax = Entrez.read(handle)[0]
        lineage = {
            item["Rank"]: item["ScientificName"]
            for item in tax.get("LineageEx", [])
        }
        out[sp] = {
            k: lineage[k] for k in ("order", "family", "genus") if k in lineage
        }
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--species-csv", help="CSV/TSV with a species column "
                   "(e.g. INSECT_metadata.csv) to enumerate species")
    p.add_argument("--taxonomy-table",
                   help="local table with species/order/family/genus columns")
    p.add_argument("--ncbi-email", help="use NCBI Entrez (needs network)")
    p.add_argument("--out", default="specie_to_other_labels.json")
    a = p.parse_args(argv)

    species = None
    if a.species_csv:
        import pandas as pd

        sep = "\t" if a.species_csv.endswith(".tsv") else ","
        species = sorted(set(pd.read_csv(a.species_csv, sep=sep)["species"]))

    if a.taxonomy_table:
        mapping = from_metadata_table(a.taxonomy_table, species)
    elif a.ncbi_email:
        mapping = from_ncbi(species or [], a.ncbi_email)
    else:
        raise SystemExit("provide --taxonomy-table or --ncbi-email")
    with open(a.out, "w") as f:
        json.dump(mapping, f, indent=2)
    print(f"wrote {a.out} ({len(mapping)} species)")


if __name__ == "__main__":
    main()
