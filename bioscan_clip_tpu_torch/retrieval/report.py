"""Full query-type x key-type retrieval sweep + report writers.

A copy of bioscan_clip_tpu/retrieval/report.py on the port's engine: each
key type is prepared once (`PreparedKeys` on `device`, default cuda) in the
precision of `inference_and_eval_setting.retrieval_precision` ("high": fp32
keys through kernel K4; "default": the same keys through K4's single bf16
pass; "int8": int8 codes through K5, rescored in fp32).

Reference parity (scripts/inference_and_eval.py:29-44, 514-715):
- feature types: query in {image, dna, language, averaged, concatenated},
  key in those + all_key_features;
- per combination: seen/unseen x micro/macro x k in k_list x 4 levels;
- outputs: ASCII table, google-doc paste rows, logs/accuracy.json,
  logs/results.csv, logs/raw.csv, logs/config.json.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from bioscan_clip_tpu_torch.retrieval.engine import (
    PreparedKeys,
    make_prediction,
)
from bioscan_clip_tpu_torch.retrieval.metrics import (
    LEVELS,
    top_k_macro_accuracy,
    top_k_micro_accuracy,
)

ALL_TYPE_OF_FEATURES_OF_QUERY = [
    "encoded_image_feature",
    "encoded_dna_feature",
    "encoded_language_feature",
    "averaged_feature",
    "concatenated_feature",
]
ALL_TYPE_OF_FEATURES_OF_KEY = ALL_TYPE_OF_FEATURES_OF_QUERY + [
    "all_key_features"
]


class Table:
    """ASCII table printer (util/util.py:27-45 behavior)."""

    def __init__(self, headers, data):
        self.headers = headers
        self.data = data
        self.column_widths = [
            max(len(str(item)) for item in column)
            for column in zip(headers, *data)
        ]

    def print_table(self, out=print):
        self.print_row(self.headers, out)
        self.print_separator(out)
        for row in self.data:
            self.print_row(row, out)

    def print_row(self, row, out=print):
        formatted = "|".join(
            f"{str(item):^{w}}" for item, w in zip(row, self.column_widths)
        )
        out(f"|{formatted}|")

    def print_separator(self, out=print):
        sep = "+".join("-" * (w + 2) for w in self.column_widths)
        out(f"+{sep}+")


def build_split_dict(
    image=None, dna=None, language=None, label_list=None,
    file_name_list=None, for_key_set: bool = False,
):
    """Assemble the per-split feature dict (inference_and_eval.py:734-783):
    averaged = elementwise mean(image, dna); concatenated = [image; dna];
    for key sets additionally stack image+dna+text rows (3N keys) with
    tripled labels."""
    averaged = concatenated = None
    if image is not None and dna is not None:
        averaged = np.mean([image, dna], axis=0)
        concatenated = np.concatenate((image, dna), axis=1)

    d = {
        "file_name_list": file_name_list,
        "encoded_dna_feature": dna,
        "encoded_image_feature": image,
        "encoded_language_feature": language,
        "averaged_feature": averaged,
        "concatenated_feature": concatenated,
        "label_list": label_list,
    }
    all_key_features = all_key_features_label = None
    if (
        for_key_set
        and image is not None
        and dna is not None
        and language is not None
    ):
        all_key_features = np.concatenate((image, dna, language), axis=0)
        all_key_features_label = list(label_list) * 3
    d["all_key_features"] = all_key_features
    d["all_key_features_label"] = all_key_features_label
    return d


def construct_key_dict(list_of_dict):
    """Merge several split dicts into one key dict by concatenating features
    and labels; all_key_features entries are dropped (train_cl.py:49-68)."""
    out = {}
    for d in list_of_dict:
        for k, v in d.items():
            if k in ("all_key_features", "all_key_features_label"):
                out[k] = None
                continue
            if k not in out:
                out[k] = v
            elif isinstance(v, list):
                out[k] = out[k] + v
            elif v is not None and out[k] is not None:
                out[k] = np.concatenate((out[k], v), axis=0)
    return out


def inference_and_print_result(
    keys_dict, seen_dict, unseen_dict, args=None, small_species_list=None,
    k_list=None, device=None, out=print, mesh=None,
):
    """Reference-parity sweep (inference_and_eval.py:633-715) on `device`
    (default cuda), or with the keys sharded over `mesh`
    (`parallel/mesh.py`). Returns (acc_dict, per_class_acc, pred_dict)."""
    acc_dict, per_class_acc, pred_dict = {}, {}, {}
    prepared_keys = {}  # key type -> PreparedKeys (one upload per key set)
    k_list = k_list or [1, 3, 5]
    max_k = k_list[-1]
    # inference_and_eval_setting.retrieval_precision=int8: resident
    # quantized keys + fp32 rescore (4x capacity); "high" = fp32 default
    precision = "high"
    if args is not None:
        ies = getattr(args, "inference_and_eval_setting", None)
        if ies is not None and hasattr(ies, "retrieval_precision"):
            precision = str(ies.retrieval_precision)

    seen_gt = seen_dict["label_list"]
    unseen_gt = unseen_dict["label_list"]

    for qt in ALL_TYPE_OF_FEATURES_OF_QUERY:
        if seen_dict.get(qt) is None:
            continue
        acc_dict[qt] = {}
        per_class_acc[qt] = {}
        pred_dict[qt] = {}
        for kt in ALL_TYPE_OF_FEATURES_OF_KEY:
            if keys_dict.get(kt) is None:
                continue
            # reference leaves an empty entry for dim-mismatched combos
            # (inference_and_eval.py:656-676)
            acc_dict[qt][kt] = {}
            per_class_acc[qt][kt] = {}
            pred_dict[qt][kt] = {}
            keys_label = (
                keys_dict["all_key_features_label"]
                if kt == "all_key_features"
                else keys_dict["label_list"]
            )
            qs, qu, kf = seen_dict[qt], unseen_dict[qt], keys_dict[kt]
            if (
                qs is None
                or qu is None
                or kf.shape[-1] != qs.shape[-1]
                or kf.shape[-1] != qu.shape[-1]
            ):
                continue

            # normalize + upload each key matrix ONCE for the whole sweep
            # (up to 5 query types x {seen, unseen} reuse it)
            if kt not in prepared_keys:
                prepared_keys[kt] = PreparedKeys(
                    kf, device=device, precision=precision, mesh=mesh
                )
            pk = prepared_keys[kt]

            seen_pred = make_prediction(qs, pk, keys_label, max_k=max_k)
            unseen_pred = make_prediction(qu, pk, keys_label, max_k=max_k)
            pred_dict[qt][kt] = {
                "curr_seen_pred_list": seen_pred,
                "curr_unseen_pred_list": unseen_pred,
            }

            entry = acc_dict[qt][kt]
            entry["seen"] = {}
            entry["unseen"] = {}
            entry["seen"]["micro_acc"] = top_k_micro_accuracy(
                seen_pred, seen_gt, k_list
            )
            entry["unseen"]["micro_acc"] = top_k_micro_accuracy(
                unseen_pred, unseen_gt, k_list
            )
            s_macro, s_pc = top_k_macro_accuracy(seen_pred, seen_gt, k_list)
            u_macro, u_pc = top_k_macro_accuracy(unseen_pred, unseen_gt, k_list)
            entry["seen"]["macro_acc"] = s_macro
            entry["unseen"]["macro_acc"] = u_macro
            per_class_acc[qt][kt] = {"seen": s_pc, "unseen": u_pc}

    print_micro_and_macro_acc(acc_dict, k_list, args, out=out)
    return acc_dict, per_class_acc, pred_dict


def print_micro_and_macro_acc(acc_dict, k_list, args=None, out=print):
    """ASCII table + CSV/JSON exports (inference_and_eval.py:514-631)."""
    header = [
        " ",
        "Seen Order", "Seen Family", "Seen Genus", "Seen Species",
        "Unseen Order", "Unseen Family", "Unseen Genus", "Unseen Species",
    ]

    model_config = getattr(args, "model_config", None) if args is not None else None
    if model_config is not None and getattr(model_config, "load_ckpt", True) is False:
        alignment = "None"
    else:
        alignment = "I"
        if model_config is not None and hasattr(model_config, "dna"):
            alignment += ",D"
        if model_config is not None and hasattr(model_config, "language"):
            alignment += ",T"
    suffix = f"({alignment})"

    csv_name = {
        "encoded_image_feature": "Image",
        "encoded_dna_feature": "DNA",
        "encoded_language_feature": "Text",
        "averaged_feature": "Ave" + suffix,
        "concatenated_feature": "Concat" + suffix,
        "all_key_features": "All" + suffix,
    }
    csv_data = [[
        "learning_strategy", "Alignment", "DNA_encoder", "Image_encoder",
        "Language_encoder", "Epoch", "Latent_space_dim", "Query", "Key",
        "Metric", "Seen_Order", "Seen_Family", "Seen_Genus", "Seen_Species",
        "Unseen_Order", "Unseen_Family", "Unseen_Genus", "Unseen_Species",
    ]]

    def read_encoder(mc, key):
        sub = getattr(mc, key, None) if mc is not None else None
        return sub.model if sub is not None else "None"

    base_row = [
        "LoRA",
        alignment,
        read_encoder(model_config, "dna"),
        read_encoder(model_config, "image"),
        read_encoder(model_config, "language"),
        getattr(model_config, "epochs", "None") if model_config else "None",
        getattr(model_config, "output_dim", "None") if model_config else "None",
    ]

    rows = []
    doc_rows = []
    for qt in ALL_TYPE_OF_FEATURES_OF_QUERY:
        if qt not in acc_dict:
            continue
        for kt in ALL_TYPE_OF_FEATURES_OF_KEY:
            if kt not in acc_dict[qt] or not acc_dict[qt][kt]:
                continue
            for type_of_acc in ["micro_acc", "macro_acc"]:
                for k in k_list:
                    row = [
                        f"Query_feature: {qt}||Key_feature: {kt}||"
                        f"{type_of_acc} top-{k}"
                    ]
                    doc_row = ""
                    csv_row = base_row + [
                        csv_name[qt],
                        csv_name[kt],
                        type_of_acc.replace("m", "M").replace(
                            "_", f"_Top-{k}_"
                        ),
                    ]
                    for split in ["seen", "unseen"]:
                        for level in LEVELS:
                            num = round(
                                acc_dict[qt][kt][split][type_of_acc][k][level],
                                4,
                            )
                            row.append(f"\t{num}")
                            doc_row += f"{num}\t"
                            csv_row.append(num)
                    rows.append(row)
                    doc_rows.append(doc_row)
                    csv_data.append(csv_row)

    if rows:
        Table(header, rows).print_table(out=out)
        out("For copy to google doc")
        for r in doc_rows:
            out(r)

    if args is not None and getattr(args, "save_inference", False):
        logs_folder = "logs"
        os.makedirs(logs_folder, exist_ok=True)
        with open(os.path.join(logs_folder, "accuracy.json"), "w") as fp:
            json.dump(acc_dict, fp)
        with open(os.path.join(logs_folder, "results.csv"), "w", newline="") as f:
            csv.writer(f, delimiter=",").writerows(csv_data)
        with open(os.path.join(logs_folder, "raw.csv"), "w", newline="") as f:
            csv.writer(f, delimiter=",").writerows(
                [r[-8:] for r in csv_data[1:]]
            )
        if hasattr(args, "to_dict"):
            with open(os.path.join(logs_folder, "config.json"), "w") as fp:
                json.dump(json.dumps(args.to_dict()), fp)
    return csv_data
