"""Sanity viewer: look up a record by processid/image_file across the split
HDF5 and save the decoded image.

A copy of bioscan_clip_tpu/cli/read_image_with_image_file_as_name.py (the
reference's scripts/read_image_with_image_file_as_name.py). The split
file is read by the port's `data/h5file.py`; PIL is imported inside the
function that needs it.

    python -m bioscan_clip_tpu_torch.cli.read_image_with_image_file_as_name
        --hdf5 FILE --name PROCESSID_OR_IMAGE_FILE [--out IMAGE]
"""

from __future__ import annotations

import argparse
import io


def find_record(hdf5_path, name):
    """(split, JPEG bytes, 4-level labels) of the first record named `name`
    (its processid in 5M files, image_file in 1M), or three Nones."""
    import numpy as np

    from bioscan_clip_tpu_torch.data import h5file

    with h5file.File(hdf5_path, "r") as f:
        for split in f.keys():
            g = f[split]
            key = "processid" if "processid" in g else "image_file"
            ids = [
                x.decode("utf-8") if isinstance(x, bytes) else str(x)
                for x in g[key][:]
            ]
            if name in ids:
                i = ids.index(name)
                enc = g["image"][i].astype(np.uint8)
                ln = g["image_mask"][i]
                labels = {
                    lvl: g[lvl][i].decode("utf-8")
                    for lvl in ("order", "family", "genus", "species")
                }
                return split, bytes(enc[:ln].tobytes()), labels
    return None, None, None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hdf5", required=True)
    p.add_argument("--name", required=True,
                   help="processid (5M) or image_file (1M)")
    p.add_argument("--out", default=None, help="save decoded image here")
    a = p.parse_args(argv)
    split, data, labels = find_record(a.hdf5, a.name)
    if split is None:
        raise SystemExit(f"{a.name} not found in {a.hdf5}")
    print(f"found in split '{split}': {labels}")
    if a.out:
        from PIL import Image

        Image.open(io.BytesIO(data)).save(a.out)
        print(f"saved {a.out}")


if __name__ == "__main__":
    main()
