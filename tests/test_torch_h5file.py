"""The port's HDF5 reader and writer (bioscan_clip_tpu_torch/data/h5file.py)
against h5py, which stays in the tests as the oracle.

- The reader on files h5py writes: {earliest, latest} x {contiguous,
  compact, chunked, chunked + gzip + shuffle, a single chunk} x {u1, i4
  and i8 in both byte orders, f2, f4, f8, vlen str, fixed S} x {0-d, 1-d,
  2-d, empty}; chunk indexes of many chunks (the paged fixed array, a
  B-tree v1 of several levels), fill values, chunks never written,
  superblock v2, groups of thousands of links in both group formats.
- Row takes with repeated and unsorted indices: the port's `SplitReader`
  against the JAX package's on h5py, and reads from 4 and 16 threads at
  once.
- The port's writer read back by h5py and by the JAX package's
  `SplitReader` and `load_feature_cache`; the JAX package's files read by
  the port.
- Every unsupported feature raises a ValueError that names it.
"""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bioscan_clip_tpu_torch.data import h5file
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LIBVERS = ("earliest", "latest")
LAYOUTS = ("contiguous", "compact", "chunked", "gzip_shuffle", "single")
DTYPES = ("u1", "<i4", ">i4", "<i8", ">i8", "<f2", "<f4", "<f8", "str", "S5")
SHAPES = {"0d": (), "1d": (13,), "2d": (9, 4), "empty": (0, 3)}
CHUNKED = ("chunked", "gzip_shuffle", "single")


def _values(dt, shape, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if dt == "str":  # UTF-8, empty strings and one of several KiB
        words = [("é" * (i % 4) + f"w{i}") * (1 + (i == 3) * 900)
                 for i in range(n)]
        words[:1] = [""] * min(n, 1)
        return np.array(words, dtype=object).reshape(shape)
    if dt.startswith("S"):
        return np.array([f"b{i}".encode() for i in range(n)],
                        dtype=dt).reshape(shape)
    d = np.dtype(dt)
    if d.kind == "f":
        return rng.standard_normal(shape).astype(d)
    return rng.integers(0, 120, size=shape).astype(d)


def _write(path, libver, layout, dt, shape):
    data = _values(dt, shape)
    dtype = h5py.string_dtype() if dt == "str" else data.dtype
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("grp")
        if layout == "compact":
            sid = (h5py.h5s.create_simple(shape) if shape
                   else h5py.h5s.create(h5py.h5s.SCALAR))
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            tid = h5py.h5t.py_create(dtype, logical=1)
            h5py.h5d.create(g.id, b"x", tid, sid, dcpl=dcpl)
            if data.size:
                g["x"][()] = data
            return data
        kw = {}
        if layout in CHUNKED:
            # empty: a fixed maxshape, so "latest" indexes by a fixed array
            maxshape = (10,) + shape[1:] if 0 in shape else shape
            chunks = (maxshape if layout == "single"
                      else tuple(max(1, s // 3) for s in maxshape))
            kw = dict(chunks=chunks, maxshape=maxshape)
            if layout == "gzip_shuffle":
                kw.update(compression="gzip", shuffle=True)
        g.create_dataset("x", data=data, dtype=dtype, **kw)
    return data


MATRIX = [(lv, lay, dt, sh) for lv in LIBVERS for lay in LAYOUTS
          for dt in DTYPES for sh in SHAPES
          if not (sh == "0d" and lay in CHUNKED)]


@pytest.mark.parametrize("libver,layout,dt,shape", MATRIX)
def test_reader_equals_h5py(tmp_path, libver, layout, dt, shape):
    path = str(tmp_path / "m.h5")
    data = _write(path, libver, layout, dt, SHAPES[shape])
    with h5py.File(path, "r") as f:
        ref = f["grp/x"]
        want, want_dtype = ref[()], ref.dtype
        rows = [ref[i] for i in range(len(ref))] if ref.shape else []
    with h5file.File(path) as f:
        ds = f["grp"]["x"]
        assert f["grp/x"] is ds
        assert ds.shape == data.shape and ds.dtype == want_dtype
        got = ds[()]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(np.asarray(ds), want)
            np.testing.assert_array_equal(ds[:], want)
        else:  # a scalar: the numpy scalar or bytes h5py gives
            assert type(got) is type(want) and got == want
        if ds.shape:
            assert len(ds) == len(rows)
            for i, r in enumerate(rows):
                np.testing.assert_array_equal(ds[i], r)
                assert type(ds[i]) is type(r)
            np.testing.assert_array_equal(ds[1:-1:2], want[1:-1:2])
            idx = np.arange(len(rows))[::-3]
            np.testing.assert_array_equal(ds[idx], want[idx])
            if len(rows):
                np.testing.assert_array_equal(ds[-1], rows[-1])


@pytest.mark.parametrize("libver", LIBVERS + ("v108",))
def test_many_chunks_fills_and_unwritten_chunks(tmp_path, libver):
    """1,500 chunks (a paged fixed array under "latest", a B-tree v1 of
    several levels under "earliest"), a fill value with chunks never
    written, a contiguous dataset never written, gzip at level 9 with
    shuffle over 2-byte elements, strings in chunks partly written."""
    path = str(tmp_path / "c.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("many", data=np.arange(12000, dtype="<i4").reshape(
            3000, 4), chunks=(2, 4))
        d = f.create_dataset("fill", shape=(50, 3), dtype="f4",
                             chunks=(10, 3), fillvalue=7.5)
        d[20:30] = 1.0
        f.create_dataset("never", shape=(9,), dtype="i8", fillvalue=-3)
        f.create_dataset("gz", data=np.arange(3001, dtype="<u2"),
                         chunks=(7,), compression="gzip",
                         compression_opts=9, shuffle=True)
        s = f.create_dataset("strs", shape=(30,), dtype=h5py.string_dtype(),
                             chunks=(4,))
        s[3:9] = ["a", "bb", "", "ccc", "dd", "e" * 900]
        f.create_dataset("ascii", data=np.array([b"x", b"yy"], dtype=object),
                         dtype=h5py.string_dtype("ascii"))
    with h5py.File(path) as f, h5file.File(path) as g:
        assert g.keys() == sorted(f.keys())
        for k in f.keys():
            assert g[k].dtype == f[k].dtype, k
            np.testing.assert_array_equal(g[k][()], f[k][()], err_msg=k)
            n = len(f[k])
            idx = np.unique(np.minimum([0, 5, 7, n // 2, n - 1], n - 1))
            np.testing.assert_array_equal(g[k][idx], f[k][idx], err_msg=k)
        assert h5py.check_string_dtype(g["ascii"].dtype).encoding == "ascii"


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("n_links", [0, 8, 9, 5000])
def test_groups_of_many_links(tmp_path, libver, n_links):
    """The INSECT image store's shape: one small dataset per image in one
    group (symbol table under "earliest"; link messages up to 8 links,
    then a fractal heap and its v2 B-tree name index under "latest")."""
    path = str(tmp_path / "g.h5")
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("images")
        for i in range(n_links):
            g.create_dataset(f"IMG{i:05d}", data=np.frombuffer(
                f"jpeg{i}".encode(), np.uint8))
    with h5py.File(path) as f, h5file.File(path) as g:
        images = g["images"]
        assert images.keys() == list(f["images"].keys())
        assert len(images.keys()) == n_links and "IMG99999" not in images
        for i in {0, n_links // 3, n_links - 1} if n_links else ():
            name = f"IMG{i:05d}"
            assert name in images
            assert np.asarray(images[name]).tobytes() == f"jpeg{i}".encode()


@pytest.fixture(scope="module")
def split_file(tmp_path_factory):
    """A split HDF5 from the JAX package's writer (h5py, "earliest"):
    JPEG-like padded rows, strings, tokens."""
    from bioscan_clip_tpu.data.hdf5 import write_split_hdf5

    rng = np.random.default_rng(3)
    n = 57
    rec = {
        "images": [rng.integers(0, 255, size=int(rng.integers(40, 90)),
                                dtype=np.uint8).tobytes() for _ in range(n)],
        "barcode": ["".join(rng.choice(list("ACGT"), size=120))
                    for _ in range(n)],
        "order": [f"order_{i % 3}" for i in range(n)],
        "family": [f"family_{i % 5}" for i in range(n)],
        "genus": [f"genus_é{i % 7}" for i in range(n)],
        "species": [f"species_{i}" for i in range(n)],
        "language_tokens": {
            k: rng.integers(0, 999, size=(n, 20)).astype(np.int64)
            for k in ("input_ids", "token_type_ids", "attention_mask")},
    }
    path = str(tmp_path_factory.mktemp("split") / "jax.h5")
    write_split_hdf5(path, {"val_seen": rec, "all_keys": rec},
                     dataset_flavor="bioscan_5m")
    return path, rec


def _same_rows(port, jax, idx):
    assert port.read_images_bytes(idx) == jax.read_images_bytes(idx)
    np.testing.assert_array_equal(port.read_dna_tokens(idx),
                                  jax.read_dna_tokens(idx))
    a, b = port.read_language_tokens(idx), jax.read_language_tokens(idx)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    assert port.read_label_dicts(idx) == jax.read_label_dicts(idx)
    assert port.read_ids(idx) == jax.read_ids(idx)


@settings(max_examples=40, derandomize=True, deadline=None, database=None)
@given(idx=st.lists(st.integers(0, 56), min_size=1, max_size=70))
def test_row_takes_equal_the_jax_reader(split_file, idx):
    """Repeated and unsorted rows through the port's SplitReader (its own
    reader) and the JAX package's (h5py)."""
    from bioscan_clip_tpu.data.hdf5 import SplitReader as JaxReader
    from bioscan_clip_tpu_torch.data.hdf5 import SplitReader

    path, rec = split_file
    port, jax = SplitReader(path, "val_seen"), JaxReader(path, "val_seen")
    _same_rows(port, jax, idx)
    assert port.read_images_bytes(idx) == [rec["images"][i] for i in idx]
    port.close()


@pytest.mark.parametrize("n_threads", [4, 16])
def test_reads_from_many_threads(split_file, tmp_path, monkeypatch,
                                 n_threads):
    """BioscanLoader's decode pool reads one SplitReader from many threads:
    4 threads, and 16 (more than this host's cores) under a 1 us switch
    interval, with the string cache cut to 8 KiB so that collections are
    evicted while other threads read them, give what one thread gives;
    so do fresh datasets whose chunk tables the threads build at once."""
    from bioscan_clip_tpu_torch.data.hdf5 import SplitReader

    path, rec = split_file
    chunked = str(tmp_path / "chunked.h5")
    with h5py.File(chunked, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(6000, dtype="<i8").reshape(
            1500, 4), chunks=(3, 4), compression="gzip", shuffle=True)
        f.create_dataset("s", data=np.array([f"s{i}" for i in range(1500)],
                                            dtype=object),
                         dtype=h5py.string_dtype(), chunks=(7,))
    monkeypatch.setattr(h5file.Dataset, "HEAP_CACHE_BYTES", 8 << 10)
    reader = SplitReader(path, "val_seen")
    other = h5file.File(chunked)
    rng = np.random.default_rng(9)
    takes = [rng.integers(0, 57, size=int(rng.integers(1, 40)))
             for _ in range(8 * n_threads)]

    def read(idx):
        rows = np.unique(idx * 26)
        return (reader.read_images_bytes(idx), reader.read_barcodes(idx),
                reader.read_label_dicts(idx),
                reader.read_language_tokens(idx)["input_ids"].tolist(),
                other["x"][rows].tolist(), other["s"][rows].tolist())

    start = threading.Barrier(n_threads)

    def worker(part):
        start.wait(timeout=60)
        return [read(idx) for idx in part]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n_threads) as pool:
            got = list(pool.map(worker, [takes[i::n_threads]
                                         for i in range(n_threads)],
                                timeout=120))
    finally:
        sys.setswitchinterval(interval)
    with h5py.File(chunked) as f:
        xs, ss = f["x"][()], f["s"][()]
    for i in range(n_threads):
        assert got[i] == [read(idx) for idx in takes[i::n_threads]]
        for idx, r in zip(takes[i::n_threads], got[i]):
            rows = np.unique(idx * 26)
            assert r[0] == [rec["images"][j] for j in idx]
            assert r[4] == xs[rows].tolist() and r[5] == ss[rows].tolist()
    reader.close()
    other.close()


def test_port_writer_read_by_h5py_and_the_jax_package(tmp_path, split_file):
    """The port's writer: a split file through the JAX SplitReader, an
    embedding cache through the JAX load_feature_cache, every dtype it
    writes and a group of 5,000 links through h5py."""
    from bioscan_clip_tpu.cli.inference_and_eval import (
        load_feature_cache as jax_load,
    )
    from bioscan_clip_tpu.data.hdf5 import SplitReader as JaxReader
    from bioscan_clip_tpu_torch.cli.inference_and_eval import (
        load_feature_cache,
        save_feature_cache,
    )
    from bioscan_clip_tpu_torch.data import hdf5

    _, rec = split_file
    path = str(tmp_path / "port.h5")
    hdf5.write_split_hdf5(path, {"val_seen": rec, "test_seen": rec},
                          max_image_bytes=95)
    for split in ("val_seen", "test_seen"):
        _same_rows(hdf5.SplitReader(path, split), JaxReader(path, split),
                   [5, 0, 56, 5, 31])
    with h5py.File(path) as f:
        assert f["val_seen/image"].shape == (57, 95)
        assert f["val_seen/genus"].dtype == h5py.string_dtype()
        assert f["val_seen/genus"][2].decode() == "genus_é2"

    rng = np.random.default_rng(4)

    def split(n):
        return {"encoded_image_feature": rng.standard_normal(
                    (n, 8)).astype(np.float32),
                "encoded_dna_feature": rng.standard_normal(
                    (n, 8)).astype(np.float32),
                "label_list": [{"species": f"s{i}"} for i in range(n)]}

    seen, unseen, keys = split(5), split(4), split(7)
    keys["all_key_features"] = rng.standard_normal((21, 8)).astype(
        np.float32)
    cache, labels = str(tmp_path / "cache.h5"), str(tmp_path / "labels.json")
    save_feature_cache(cache, labels, seen, unseen, keys)
    for load in (jax_load, load_feature_cache):
        got = load(cache, labels)
        for want, have in zip((seen, unseen, keys), got):
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(have[k], v)
                else:
                    assert have[k] == v

    arrays = {
        "u1": np.arange(24, dtype=np.uint8).reshape(2, 3, 4),
        "i4": np.array([-5, 7], np.int32), "i8": np.int64(-9),
        "f2": np.array([1.5, -2.25], np.float16),
        "f4": rng.standard_normal((3, 2)).astype(np.float32),
        "f8": rng.standard_normal(5), "be": np.arange(3, dtype=">i4"),
        "empty": np.zeros((0, 4), np.float32),
    }
    strings = ["", "a", "é" * 2500] + [f"n{i}" for i in range(700)]
    other = str(tmp_path / "dtypes.h5")
    with h5file.File(other, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(f"nested/deeper/{k}", data=v)
        f.create_dataset("strings", data=np.array(strings, dtype=object),
                         dtype=h5file.STRING)
        f.create_dataset("no_strings", data=np.array([], dtype=object),
                         dtype=h5file.STRING)
        g = f.create_group("images")
        for i in range(5000):
            g.create_dataset(f"IMG{i:05d}", data=np.frombuffer(
                f"jpeg{i}".encode(), np.uint8))
        f.create_group("empty_group")
        assert "images" in f and "nested" in f.keys()
    with h5py.File(other) as f, h5file.File(other) as g:
        for k, v in arrays.items():
            x = f[f"nested/deeper/{k}"]
            assert x.dtype == np.asarray(v).dtype and x.shape == np.shape(v)
            np.testing.assert_array_equal(x[()], v)
            np.testing.assert_array_equal(g[f"nested/deeper/{k}"][()], v)
        for r in (f, g):
            assert [s.decode() for s in r["strings"][()]] == strings
            assert len(r["no_strings"]) == 0
        assert f["strings"].dtype == h5py.string_dtype()
        assert list(f["images"].keys()) == [f"IMG{i:05d}" for i in
                                            range(5000)]
        for i in (0, 2500, 4999):
            assert f[f"images/IMG{i:05d}"][()].tobytes() == (
                f"jpeg{i}".encode())
        assert list(f["empty_group"].keys()) == []


def test_jax_files_read_by_the_port(tmp_path, split_file):
    """The JAX package's split file and embedding cache (h5py) read by
    the port equal the JAX readers."""
    from bioscan_clip_tpu.cli.inference_and_eval import (
        load_feature_cache as jax_load,
        save_feature_cache as jax_save,
    )
    from bioscan_clip_tpu.data.hdf5 import SplitReader as JaxReader
    from bioscan_clip_tpu.data.hdf5 import get_len_dict as jax_lens
    from bioscan_clip_tpu_torch.cli.inference_and_eval import (
        load_feature_cache,
    )
    from bioscan_clip_tpu_torch.data.hdf5 import SplitReader, get_len_dict
    from tests.fixtures import SyntheticArgs

    path, _ = split_file
    everything = list(range(57))
    _same_rows(SplitReader(path, "all_keys"), JaxReader(path, "all_keys"),
               everything)
    args = SyntheticArgs(path)
    assert get_len_dict(args) == jax_lens(args) == {"all_keys": 57,
                                                    "val_seen": 57}
    rng = np.random.default_rng(5)
    parts = [{"encoded_language_feature": rng.standard_normal(
        (n, 6)).astype(np.float32), "label_list": [{"genus": "g"}] * n}
        for n in (3, 2, 4)]
    cache, labels = str(tmp_path / "jax.h5"), str(tmp_path / "labels.json")
    jax_save(cache, labels, *parts)
    for a, b in zip(load_feature_cache(cache, labels),
                    jax_load(cache, labels)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k], dtype=object),
                                          np.asarray(b[k], dtype=object))


def _unsupported(f, name):
    """Write one dataset or link of an unsupported kind into `f`."""
    if name == "lzf":
        f.create_dataset("x", data=np.arange(10), chunks=(5,),
                         compression="lzf")
    elif name == "fletcher32":
        f.create_dataset("x", data=np.arange(10), chunks=(5,),
                         fletcher32=True)
    elif name == "scaleoffset":
        f.create_dataset("x", data=np.arange(10), chunks=(5,),
                         scaleoffset=0)
    elif name == "compound":
        f.create_dataset("x", data=np.zeros(3, [("a", "i4"), ("b", "f4")]))
    elif name == "enum":  # numpy bool is an HDF5 enum
        f.create_dataset("x", data=np.array([True, False]))
    elif name == "array":
        f.create_dataset("x", shape=(2,), dtype=np.dtype(("i4", (3,))))
    elif name == "reference":
        f.create_dataset("x", shape=(2,), dtype=h5py.ref_dtype)
    elif name == "opaque":
        f.create_dataset("x", data=np.void(b"\x01\x02"))
    elif name == "variable-length sequence":
        f.create_dataset("x", shape=(2,), dtype=h5py.vlen_dtype("i4"))
    elif name == "null dataspace":
        f.create_dataset("x", data=h5py.Empty("f4"))
    elif name == "extensible array":
        f.create_dataset("x", data=np.arange(10), chunks=(4,),
                         maxshape=(None,))
    elif name == "v2 B-tree":
        f.create_dataset("x", data=np.zeros((4, 4)), chunks=(2, 2),
                         maxshape=(None, None))
    elif name == "implicit":
        sid = h5py.h5s.create_simple((10,))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((5,))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_INT32, sid, dcpl=dcpl)
    elif name == "soft":
        f["target"] = np.arange(3)
        f["x"] = h5py.SoftLink("/target")
    elif name == "external":
        f["x"] = h5py.ExternalLink("other.h5", "/data")
    else:
        raise AssertionError(name)


UNSUPPORTED = ("lzf", "fletcher32", "scaleoffset", "compound", "enum",
               "array", "reference", "opaque", "variable-length sequence",
               "null dataspace", "extensible array", "v2 B-tree",
               "implicit", "soft", "external")


@pytest.mark.parametrize("name", UNSUPPORTED)
def test_unsupported_features_raise_with_their_name(tmp_path, name):
    path = str(tmp_path / "u.h5")
    latest = name in ("extensible array", "v2 B-tree", "implicit")
    with h5py.File(path, "w", libver="latest" if latest else "earliest") as f:
        _unsupported(f, name)
    with h5file.File(path) as f:
        assert "x" in f.keys()
        with pytest.raises(ValueError, match=name):
            f["x"]


def test_checksums_and_what_the_writer_refuses(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(4)
    with h5file.File(path) as f:
        np.testing.assert_array_equal(f["x"][()], np.arange(4))
    raw = bytearray(open(path, "rb").read())
    raw[20] ^= 0xFF  # inside the superblock's root address
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        h5file.File(path)
    (tmp_path / "text.h5").write_text("not hdf5")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5file.File(str(tmp_path / "text.h5"))
    with h5file.File(str(tmp_path / "w.h5"), "w") as f:
        with pytest.raises(TypeError, match="bool"):
            f.create_dataset("b", data=np.array([True]))
        f.create_dataset("a", data=np.arange(2))
        with pytest.raises(ValueError, match="already exists"):
            f.create_dataset("a", data=np.arange(2))
    with pytest.raises(ValueError, match="mode"):
        h5file.File(str(tmp_path / "w.h5"), "a")
