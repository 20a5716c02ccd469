"""Reader and writer for the subset of HDF5 that the system's files use,
in numpy and the standard library.

The split files, the INSECT image store, the eval job's embedding cache and
`extract_embedding`'s exports are HDF5. This module reads what h5py writes
under its two defaults, `libver="earliest"` and `"latest"`:
- superblock v0/v1, v2 and v3 (the last two with their Jenkins lookup3
  checksum checked);
- object headers v1 and v2 (checksum checked), with continuation blocks;
- groups as symbol tables (B-tree v1, local heap, SNOD), as link
  messages in the header, and as dense links (a fractal heap whose
  objects the v2 B-tree name index lists);
- compact, contiguous and chunked layouts; chunks indexed by a B-tree v1,
  a single chunk or a fixed array; the deflate and shuffle filters;
- little- and big-endian integers of 1-8 bytes, IEEE floats of 2, 4 and 8
  bytes, variable-length strings in the global heap (UTF-8 and ASCII),
  fixed-length byte strings; fill values and chunks never written.

Anything else raises a `ValueError` that names the feature and the
object: other filters, the implicit, extensible-array and v2 B-tree chunk
indexes, compound, enum, array, reference and other datatypes, soft and
external links, shared messages. Attributes are not read.

A row take (`ds[i]`, a slice, an integer array) reads only the bytes of
those rows: one `os.preadv` per run of adjacent rows of a contiguous
dataset, each touched chunk once for a chunked one. Every read is a
positioned read on one descriptor, so a file is safe to read from many
threads at once. A string dataset keeps the global-heap collections it
parsed, up to `Dataset.HEAP_CACHE_BYTES`.

The writer (`File(path, "w")`) writes superblock v0, v1 object headers,
symbol-table groups and contiguous datasets: N-d numeric arrays and
variable-length UTF-8 strings (`dtype=STRING`), which h5py and the JAX
package read back.

    with File(path, "w") as f:
        g = f.create_group("val_seen")
        g.create_dataset("image", data=np.zeros((4, 8), np.uint8))
        g.create_dataset("species", data=["a", "b"], dtype=STRING)
    with File(path) as f:
        rows = f["val_seen/image"][np.array([0, 2])]
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from collections import OrderedDict

import numpy as np

__all__ = ["File", "Group", "Dataset", "STRING"]

# variable-length UTF-8 strings, as h5py.string_dtype() is
STRING = np.dtype("O", metadata={"vlen": str})

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 10: "array"}
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                 307: "bzip2", 32000: "lzf", 32001: "blosc",
                 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
_INDEX_NAMES = {2: "implicit", 4: "extensible array", 5: "v2 B-tree"}
# IEEE layouts by size: precision, exponent location and size, mantissa
# location and size, exponent bias
_IEEE = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
         8: (64, 52, 11, 0, 52, 1023)}


def _u(b, p, n):
    return int.from_bytes(b[p:p + n], "little")


def _lookup3(data: bytes, init: int = 0) -> int:
    """Bob Jenkins' lookup3 `hashlittle`, the checksum of HDF5's v2
    metadata."""
    m = 0xFFFFFFFF

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & m

    n = len(data)
    a = b = c = (0xDEADBEEF + n + init) & m
    p = 0
    while n - p > 12:
        a = (a + _u(data, p, 4)) & m
        b = (b + _u(data, p + 4, 4)) & m
        c = (c + _u(data, p + 8, 4)) & m
        a = (a - c) & m; a ^= rot(c, 4); c = (c + b) & m
        b = (b - a) & m; b ^= rot(a, 6); a = (a + c) & m
        c = (c - b) & m; c ^= rot(b, 8); b = (b + a) & m
        a = (a - c) & m; a ^= rot(c, 16); c = (c + b) & m
        b = (b - a) & m; b ^= rot(a, 19); a = (a + c) & m
        c = (c - b) & m; c ^= rot(b, 4); b = (b + a) & m
        p += 12
    if n == p:
        return c
    tail = bytes(data[p:]) + bytes(12 - (n - p))
    a = (a + _u(tail, 0, 4)) & m
    b = (b + _u(tail, 4, 4)) & m
    c = (c + _u(tail, 8, 4)) & m
    c ^= b; c = (c - rot(b, 14)) & m
    a ^= c; a = (a - rot(c, 11)) & m
    b ^= a; b = (b - rot(a, 25)) & m
    c ^= b; c = (c - rot(b, 16)) & m
    a ^= c; a = (a - rot(c, 4)) & m
    b ^= a; b = (b - rot(a, 14)) & m
    c ^= b; c = (c - rot(b, 24)) & m
    return c


def _check_sum(block: bytes, what: str):
    if _lookup3(block[:-4]) != _u(block, len(block) - 4, 4):
        raise ValueError(f"HDF5 {what}: checksum mismatch")


# ------------------------------------------------------------------ reading


class _Source:
    """The open file: a descriptor read only by positioned reads, the
    superblock's sizes, and the objects opened so far by header address."""

    def __init__(self, path: str):
        self.path = str(path)
        self.fd = None
        self.fd = os.open(self.path, os.O_RDONLY)
        self.lock = threading.Lock()
        self.objects: dict = {}
        try:
            self._superblock()
        except BaseException:
            self.close()
            raise

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

    def __del__(self):
        self.close()

    def read(self, addr: int, n: int) -> bytes:
        if self.fd is None:
            raise ValueError(f"{self.path}: the file is closed")
        data = os.pread(self.fd, n, self.base + addr)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated at {addr} (+{n})")
        return data

    def read_into(self, mv: memoryview, addr: int):
        """Fill `mv` from the file at `addr`."""
        off = 0
        while off < len(mv):
            got = os.preadv(self.fd, [mv[off:]], self.base + addr + off)
            if got <= 0:
                raise ValueError(f"{self.path}: truncated at {addr + off}")
            off += got

    def _superblock(self):
        for at in (0, 512, 1024, 2048, 4096, 8192):
            if os.pread(self.fd, 8, at) == _SIGNATURE:
                break
        else:
            raise ValueError(f"{self.path}: not an HDF5 file")
        # addresses count from the superblock (the base address)
        self.base = at
        b = os.pread(self.fd, 256, at)
        version = b[8]
        if version in (0, 1):
            self.O, self.L = b[13], b[14]
            p = 24 + (4 if version == 1 else 0)
            root_entry = p + 4 * self.O
            self.root = _u(b, root_entry + self.O, self.O)
        elif version in (2, 3):
            self.O, self.L = b[9], b[10]
            p = 12
            self.root = _u(b, p + 3 * self.O, self.O)
            _check_sum(b[:p + 4 * self.O + 4], f"{self.path} superblock")
        else:
            raise ValueError(f"{self.path}: superblock version {version} "
                             "is not supported")

    def addr(self, b, p) -> int:
        return _u(b, p, self.O)

    def defined(self, a: int) -> bool:
        return a != (1 << (8 * self.O)) - 1

    def node(self, addr: int, name: str):
        """The Group or Dataset whose object header is at `addr`."""
        with self.lock:
            obj = self.objects.get(addr)
        if obj is not None:
            return obj
        msgs = self.header(addr, name)
        types = {t for t, _, _ in msgs}
        if 0x0008 in types:
            obj = Dataset(self, name, msgs)
        elif types & {0x0011, 0x0002, 0x0006}:
            obj = Group(self, name, msgs)
        else:
            raise ValueError(f"{self.path}:{name}: an object that is neither "
                             "a group nor a dataset (a committed datatype?)")
        with self.lock:
            return self.objects.setdefault(addr, obj)

    def header(self, addr: int, name: str) -> list:
        """[(type, flags, body)] of the object header at `addr`, with its
        continuation blocks."""
        first = self.read(addr, 16)
        out: list = []
        if first[:4] == b"OHDR":
            flags = first[5]
            p = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            size_len = 1 << (flags & 3)
            pre = self.read(addr, p + size_len)
            chunk0 = _u(pre, p, size_len)
            block = self.read(addr, p + size_len + chunk0 + 4)
            _check_sum(block, f"{self.path}:{name} object header")
            blocks = [(block, p + size_len, len(block) - 4)]
            order = bool(flags & 0x04)
            while blocks:
                b, s, e = blocks.pop(0)
                for mtype, mflags, body in self._messages_v2(b, s, e, order):
                    self._take(out, blocks, mtype, mflags, body, name, 2)
        elif first[0] == 1:
            size = _u(first, 8, 4)
            blocks = [(self.read(addr + 16, size), 0, size)]
            while blocks:
                b, s, e = blocks.pop(0)
                p = s
                while p + 8 <= e:
                    mtype, msize, mflags = (_u(b, p, 2), _u(b, p + 2, 2),
                                            b[p + 4])
                    body = b[p + 8:p + 8 + msize]
                    p += 8 + msize
                    self._take(out, blocks, mtype, mflags, body, name, 1)
        else:
            raise ValueError(f"{self.path}:{name}: object header version "
                             f"{first[0]} is not supported")
        return out

    @staticmethod
    def _messages_v2(b, s, e, order):
        hdr = 6 if order else 4
        p = s
        while p + hdr <= e:
            mtype, msize, mflags = b[p], _u(b, p + 1, 2), b[p + 3]
            body = b[p + hdr:p + hdr + msize]
            p += hdr + msize
            yield mtype, mflags, body

    def _take(self, out, blocks, mtype, mflags, body, name, version):
        if mtype == 0x0010:  # continuation
            a, n = self.addr(body, 0), _u(body, self.O, self.L)
            b = self.read(a, n)
            if version == 2:
                if b[:4] != b"OCHK":
                    raise ValueError(f"{self.path}:{name}: bad continuation "
                                     "block")
                _check_sum(b, f"{self.path}:{name} continuation block")
                blocks.append((b, 4, n - 4))
            else:
                blocks.append((b, 0, n))
        elif mtype != 0:
            if mflags & 0x02 and mtype in (0x0001, 0x0003, 0x0005, 0x000B):
                raise ValueError(f"{self.path}:{name}: shared object header "
                                 f"message (type {mtype}) is not supported")
            out.append((mtype, mflags, body))

    # ------------------------------------------------------------ heaps

    def local_heap(self, addr: int) -> bytes:
        b = self.read(addr, 8 + 2 * self.L + self.O)
        if b[:4] != b"HEAP":
            raise ValueError(f"{self.path}: bad local heap at {addr}")
        size = _u(b, 8, self.L)
        return self.read(self.addr(b, 8 + 2 * self.L), size)

    def collection(self, addr: int) -> dict:
        """{index: bytes} of the global-heap collection at `addr`."""
        head = self.read(addr, 8 + self.L)
        if head[:4] != b"GCOL":
            raise ValueError(f"{self.path}: bad global heap at {addr}")
        size = _u(head, 8, self.L)
        b = self.read(addr, size)
        objs = {}
        p = 8 + self.L
        hdr = 8 + self.L
        while p + hdr <= size:
            idx, n = _u(b, p, 2), _u(b, p + 8, self.L)
            if idx == 0:
                break
            objs[idx] = b[p + hdr:p + hdr + n]
            p += hdr + ((n + 7) & ~7)
        return objs


class _FractalHeap:
    """Managed objects of a fractal heap (dense links' storage); tiny and
    huge objects and filtered heaps raise."""

    def __init__(self, src: _Source, addr: int, what: str):
        self.src, self.what = src, what
        O, L = src.O, src.L
        b = src.read(addr, 256)
        if b[:4] != b"FRHP":
            raise ValueError(f"{what}: bad fractal heap header")
        p = 5
        filt_len, max_man = _u(b, p + 2, 2), _u(b, p + 5, 4)
        p += 9 + L + O + L + O + 8 * L
        if filt_len:
            raise ValueError(f"{what}: a filtered fractal heap is not "
                             "supported")
        self.width = _u(b, p, 2)
        self.start = _u(b, p + 2, L)
        self.max_direct = _u(b, p + 2 + L, L)
        max_bits = _u(b, p + 2 + 2 * L, 2)
        self.root = src.addr(b, p + 6 + 2 * L)
        self.root_rows = _u(b, p + 6 + 2 * L + O, 2)
        self.off_size = (max_bits + 7) // 8
        dir_off_size = (self.max_direct.bit_length() - 1 + 7) // 8
        self.len_size = min(dir_off_size, (max_man.bit_length() - 1) // 8 + 1)
        self.first_row_bits = ((self.start.bit_length() - 1)
                                + (self.width.bit_length() - 1))
        self.max_direct_rows = ((self.max_direct.bit_length() - 1)
                                - (self.start.bit_length() - 1) + 2)
        self.blocks: dict = {}

    def _row(self, r):
        """(block size, offset of the row's first block) of row r."""
        size = self.start if r == 0 else self.start << (r - 1)
        off = 0 if r == 0 else (self.start * self.width) << (r - 1)
        return size, off

    def _block(self, addr, size):
        b = self.blocks.get(addr)
        if b is None:
            b = self.blocks[addr] = self.src.read(addr, size)
        return b

    def get(self, hid: bytes) -> bytes:
        if (hid[0] >> 4) & 3:  # a link message is a managed object
            raise ValueError(f"{self.what}: a tiny or huge fractal heap "
                             "object is not supported")
        off = _u(hid, 1, self.off_size)
        n = _u(hid, 1 + self.off_size, self.len_size)
        if self.root_rows == 0:  # the root is a direct block
            return self.src.read(self.root + off, n)
        iaddr, ioff, nrows = self.root, 0, self.root_rows
        O = self.src.O
        while True:
            rel = off - ioff
            if rel < self.start * self.width:
                row, col = 0, rel // self.start
            else:
                row = rel.bit_length() - 1 - self.first_row_bits + 1
                size, roff = self._row(row)
                col = (rel - roff) // size
            size, roff = self._row(row)
            head = 5 + O + self.off_size
            entry = self._block(iaddr, head + nrows * self.width * O)
            child = self.src.addr(entry, head + (row * self.width + col) * O)
            child_off = ioff + roff + col * size
            if row < self.max_direct_rows:
                return self._block(child, size)[off - child_off:
                                                off - child_off + n]
            iaddr, ioff = child, child_off
            nrows = (size.bit_length() - 1) - self.first_row_bits + 1


def _btree2_records(src: _Source, addr: int, what: str):
    """Every record of the v2 B-tree whose header is at `addr`."""
    O = src.O
    b = src.read(addr, 16 + O + 2 + src.L + 4)
    if b[:4] != b"BTHD":
        raise ValueError(f"{what}: bad v2 B-tree header")
    node_size, rec_size, depth = _u(b, 6, 4), _u(b, 10, 2), _u(b, 12, 2)
    root, root_nrec = src.addr(b, 16), _u(b, 16 + O, 2)
    max_nrec = [(node_size - 10) // rec_size]
    cum = [max_nrec[0]]
    cum_size = [0]
    nrec_size = (max_nrec[0].bit_length() - 1) // 8 + 1
    for d in range(1, depth + 1):
        ptr = O + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
        cum.append((max_nrec[d] + 1) * cum[d - 1] + max_nrec[d])
        cum_size.append((cum[d].bit_length() - 1) // 8 + 1)
    out = []

    def walk(a, nrec, d):
        node = src.read(a, node_size)
        if node[:4] not in (b"BTIN", b"BTLF"):
            raise ValueError(f"{what}: bad v2 B-tree node")
        p = 6
        for _ in range(nrec):
            out.append(node[p:p + rec_size])
            p += rec_size
        if d == 0:
            return
        for _ in range(nrec + 1):
            child = src.addr(node, p)
            n = _u(node, p + O, nrec_size)
            p += O + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            walk(child, n, d - 1)

    if src.defined(root):
        walk(root, root_nrec, depth)
    return out


def _link(src: _Source, body: bytes, what: str):
    """(name, target) of a link message: target is a header address, or
    ("soft" | "external", ...) for the links this reader does not follow."""
    flags = body[1]
    p = 2
    kind = 0
    if flags & 0x08:
        kind = body[p]
        p += 1
    if flags & 0x04:
        p += 8
    if flags & 0x10:
        p += 1
    n_len = 1 << (flags & 3)
    n = _u(body, p, n_len)
    p += n_len
    name = body[p:p + n].decode("utf-8")
    p += n
    if kind == 0:
        return name, src.addr(body, p)
    return name, ("soft" if kind == 1 else "external",)


class Group:
    """A group of the file: `keys()` (by name), `in` and `[path]`."""

    def __init__(self, src: _Source, name: str, msgs: list):
        self._src, self.name = src, name
        self._msgs = msgs
        self._links = None

    def _table(self) -> dict:
        if self._links is None:
            links = self._read_links()
            self._links = {k: links[k] for k in sorted(
                links, key=lambda s: s.encode("utf-8"))}
        return self._links

    def _read_links(self) -> dict:
        src, what = self._src, f"{self._src.path}:{self.name}"
        links: dict = {}
        for mtype, _, body in self._msgs:
            if mtype == 0x0011:  # symbol table
                self._symbol_table(src.addr(body, 0),
                                   src.addr(body, src.O), links)
            elif mtype == 0x0006:
                name, target = _link(src, body, what)
                links[name] = target
            elif mtype == 0x0002:  # link info: dense storage
                p = 2 + (8 if body[1] & 1 else 0)
                heap, index = src.addr(body, p), src.addr(body, p + src.O)
                if src.defined(heap):
                    fh = _FractalHeap(src, heap, what)
                    for rec in _btree2_records(src, index, what):
                        name, target = _link(src, fh.get(rec[4:]), what)
                        links[name] = target
        return links

    def _symbol_table(self, btree, heap_addr, links):
        src = self._src
        heap = src.local_heap(heap_addr)
        O, L = src.O, src.L

        def name_at(off):
            return heap[off:heap.index(b"\0", off)].decode("utf-8")

        def walk(addr):
            head = src.read(addr, 8 + 2 * O)
            if head[:4] != b"TREE" or head[4] != 0:
                raise ValueError(f"{src.path}:{self.name}: bad group B-tree")
            level, n = head[5], _u(head, 6, 2)
            b = src.read(addr, 8 + 2 * O + n * (L + O) + L)
            for i in range(n):
                child = src.addr(b, 8 + 2 * O + i * (L + O) + L)
                if level:
                    walk(child)
                else:
                    snod(child)

        def snod(addr):
            head = src.read(addr, 8)
            if head[:4] != b"SNOD":
                raise ValueError(f"{src.path}:{self.name}: bad symbol node")
            n = _u(head, 6, 2)
            size = 2 * O + 24
            b = src.read(addr + 8, n * size)
            for i in range(n):
                e = i * size
                name = name_at(_u(b, e, O))
                cache = _u(b, e + 2 * O, 4)
                links[name] = ("soft",) if cache == 2 else src.addr(b, e + O)

        walk(btree)

    def keys(self):
        return list(self._table())

    def __contains__(self, path) -> bool:
        try:
            self._resolve(path, probe=True)
        except KeyError:
            return False
        return True

    def __getitem__(self, path):
        return self._resolve(path)

    def _resolve(self, path, probe=False):
        node = self
        for part in [p for p in str(path).split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(f"{path!r}: {node.name} is not a group")
            target = node._table().get(part)
            if target is None:
                raise KeyError(f"{path!r} not in {self._src.path}:"
                               f"{node.name}")
            if isinstance(target, tuple):
                if probe:
                    return None
                raise ValueError(f"{self._src.path}:{node.name}/{part}: a "
                                 f"{target[0]} link is not supported")
            name = (node.name.rstrip("/") + "/" + part)
            node = self._src.node(target, name)
        return node


class _Type:
    """A dataset's element type: the numpy dtype the caller sees, how the
    file stores it (`stored`), and whether it is a variable-length string
    that the global heap holds."""

    def __init__(self, dtype, stored, vlen=False):
        self.dtype, self.stored, self.vlen = dtype, stored, vlen


def _datatype(b: bytes, O: int, what: str) -> _Type:
    cls, bits, size = b[0] & 0x0F, _u(b, 1, 3), _u(b, 4, 4)
    if cls == 0:
        offset, precision = _u(b, 8, 2), _u(b, 10, 2)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise ValueError(f"{what}: an integer of {size} bytes at bit "
                             f"precision {precision} is not supported")
        kind = "i" if bits & 0x08 else "u"
        order = ">" if bits & 0x01 else "<"
        dt = np.dtype(f"{order}{kind}{size}")
        return _Type(dt, dt)
    if cls == 1:
        if bits & 0x40:
            raise ValueError(f"{what}: VAX float byte order is not supported")
        layout = (_u(b, 10, 2), b[12], b[13], b[14], b[15], _u(b, 16, 4))
        if _IEEE.get(size) != layout or _u(b, 8, 2):
            raise ValueError(f"{what}: a non-IEEE float of {size} bytes is "
                             "not supported")
        dt = np.dtype(f"{'>' if bits & 0x01 else '<'}f{size}")
        return _Type(dt, dt)
    if cls == 3:
        dt = np.dtype(f"S{size}")
        return _Type(dt, dt)
    if cls == 9:
        if bits & 0x0F != 1:
            raise ValueError(f"{what}: a variable-length sequence is not "
                             "supported")
        utf8 = (bits >> 8) & 0x0F == 1
        dt = np.dtype("O", metadata={"vlen": str if utf8 else bytes})
        stored = np.dtype([("n", "<u4"), ("addr", f"<u{O}"), ("idx", "<u4")])
        return _Type(dt, stored, vlen=True)
    raise ValueError(f"{what}: the {_CLASS_NAMES.get(cls, f'class {cls}')} "
                     "datatype is not supported")


class Dataset:
    """A dataset of the file: `shape`, `dtype`, `len`, `[()]`, and rows of
    the first axis by `[i]`, `[slice]` and `[integer array]` (repeated and
    unsorted rows too); `numpy.asarray(ds)`. Strings come back as `bytes`,
    as h5py gives them."""

    # the parsed global-heap collections a string dataset keeps
    HEAP_CACHE_BYTES = 64 << 20

    def __init__(self, src: _Source, name: str, msgs: list):
        self._src, self.name = src, name
        what = f"{src.path}:{name}"
        self._what = what
        by_type: dict = {}
        for mtype, _, body in msgs:
            by_type.setdefault(mtype, body)
        self.shape, self.maxshape = self._dataspace(by_type[0x0001])
        self._type = _datatype(by_type[0x0003], src.O, what)
        self.dtype = self._type.dtype
        self._filters = self._pipeline(by_type.get(0x000B))
        self._fill = self._fill_value(by_type)
        self._layout(by_type[0x0008])
        self._lock = threading.Lock()
        self._chunks = None
        self._heap: OrderedDict = OrderedDict()
        self._heap_bytes = 0

    # ------------------------------------------------------------ parsing

    def _dataspace(self, b):
        L = self._src.L
        version, rank, flags = b[0], b[1], b[2]
        if version == 1:
            p = 8
        elif version == 2:
            if b[3] == 2:
                raise ValueError(f"{self._what}: a null dataspace is not "
                                 "supported")
            p = 4
        else:
            raise ValueError(f"{self._what}: dataspace version {version} "
                             "is not supported")
        dims = tuple(_u(b, p + L * i, L) for i in range(rank))
        maxdims = dims
        if flags & 1:
            maxdims = tuple(_u(b, p + L * (rank + i), L) for i in range(rank))
        return dims, maxdims

    def _pipeline(self, b):
        if b is None:
            return []
        version, n = b[0], b[1]
        p = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = _u(b, p, 2)
            p += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = _u(b, p, 2)
                p += 2
            flags, nvals = _u(b, p, 2), _u(b, p + 2, 2)
            p += 4
            if version == 1:
                p += (name_len + 7) & ~7
            else:
                p += name_len
            vals = [_u(b, p + 4 * i, 4) for i in range(nvals)]
            p += 4 * nvals
            if version == 1 and nvals % 2:
                p += 4
            if fid not in (1, 2):
                raise ValueError(
                    f"{self._what}: the "
                    f"{_FILTER_NAMES.get(fid, 'unknown')} filter ({fid}) is "
                    "not supported")
            out.append((fid, flags, vals))
        return out

    def _fill_value(self, by_type):
        b = by_type.get(0x0005)
        value = None
        if b is not None:
            if b[0] in (1, 2):
                if b[0] == 1 or b[3]:
                    n = _u(b, 4, 4)
                    value = b[8:8 + n] if n else None
            elif b[1] & 0x20:
                n = _u(b, 2, 4)
                value = b[6:6 + n] if n else None
        elif 0x0004 in by_type:
            o = by_type[0x0004]
            n = _u(o, 0, 4)
            value = o[4:4 + n] if n else None
        stored = self._type.stored
        if value is None or len(value) != stored.itemsize:
            return np.zeros((), stored)
        return np.frombuffer(value, stored).reshape(())

    def _layout(self, b):
        src, version = self._src, b[0]
        if version not in (3, 4):
            raise ValueError(f"{self._what}: layout message version "
                             f"{version} is not supported")
        cls = b[1]
        self._index = None
        if cls == 0:
            n = _u(b, 2, 2)
            self._storage = ("compact", b[4:4 + n])
        elif cls == 1:
            self._storage = ("contiguous", src.addr(b, 2),
                             _u(b, 2 + src.O, src.L))
        elif cls == 2 and version == 3:
            nd = b[2]
            addr = src.addr(b, 3)
            dims = [_u(b, 3 + src.O + 4 * i, 4) for i in range(nd)]
            self._storage = ("chunked", tuple(dims[:-1]), False)
            self._index = ("btree1", addr)
        elif cls == 2:
            flags, nd, enc = b[2], b[3], b[4]
            p = 5
            dims = [_u(b, p + enc * i, enc) for i in range(nd)]
            p += enc * nd
            itype = b[p]
            p += 1
            self._storage = ("chunked", tuple(dims[:-1]), bool(flags & 1))
            if itype == 1:
                size = mask = None
                if flags & 2:
                    size, mask = _u(b, p, src.L), _u(b, p + src.L, 4)
                    p += src.L + 4
                self._index = ("single", src.addr(b, p), size, mask)
            elif itype == 3:
                self._index = ("farray", src.addr(b, p + 1))
            else:
                raise ValueError(
                    f"{self._what}: the "
                    f"{_INDEX_NAMES.get(itype, f'type {itype}')} chunk "
                    "index is not supported")
        else:
            raise ValueError(f"{self._what}: the "
                             f"{'virtual' if cls == 3 else cls} layout is "
                             "not supported")

    # ------------------------------------------------------------ chunks

    def _chunk_table(self) -> dict:
        """{chunk grid coordinates: (address, stored bytes, filter mask)}."""
        with self._lock:
            if self._chunks is not None:
                return self._chunks
        src = self._src
        cshape = self._storage[1]
        itemsize = self._type.stored.itemsize
        full = int(np.prod(cshape)) * itemsize
        table = {}
        kind = self._index[0]
        if kind == "single":
            _, addr, size, mask = self._index
            if src.defined(addr):
                table[(0,) * len(cshape)] = (addr, size or full, mask or 0)
        elif kind == "btree1":
            rank = len(cshape)
            key = 8 + 8 * (rank + 1)
            O = src.O

            def walk(addr):
                head = src.read(addr, 8 + 2 * O)
                if head[:4] != b"TREE" or head[4] != 1:
                    raise ValueError(f"{self._what}: bad chunk B-tree")
                level, n = head[5], _u(head, 6, 2)
                b = src.read(addr, 8 + 2 * O + n * (key + O) + key)
                for i in range(n):
                    k = 8 + 2 * O + i * (key + O)
                    child = src.addr(b, k + key)
                    if level:
                        walk(child)
                    else:
                        offs = [_u(b, k + 8 + 8 * d, 8) for d in range(rank)]
                        table[tuple(o // c for o, c in zip(offs, cshape))] = (
                            child, _u(b, k, 4), _u(b, k + 4, 4))

            if src.defined(self._index[1]):
                walk(self._index[1])
        else:
            table = self._fixed_array(self._index[1], cshape, full)
        with self._lock:
            self._chunks = table
        return table

    def _fixed_array(self, addr, cshape, full) -> dict:
        src, O, L = self._src, self._src.O, self._src.L
        if not src.defined(addr):
            return {}
        h = src.read(addr, 8 + L + O + 4)
        if h[:4] != b"FAHD":
            raise ValueError(f"{self._what}: bad fixed array header")
        client, esize, page_bits = h[5], h[6], h[7]
        n = _u(h, 8, L)
        dblk = src.addr(h, 8 + L)
        prefix = 6 + O
        per_page = 1 << page_bits
        entries = []
        if n > per_page:
            npages = -(-n // per_page)
            bitmap = src.read(dblk + prefix, (npages + 7) // 8)
            p = dblk + prefix + len(bitmap) + 4
            for pg in range(npages):
                cnt = min(per_page, n - pg * per_page)
                if bitmap[pg // 8] & (0x80 >> (pg % 8)):
                    raw = src.read(p, cnt * esize)
                    entries += [raw[i * esize:(i + 1) * esize]
                                for i in range(cnt)]
                else:
                    entries += [None] * cnt
                p += cnt * esize + 4
        else:
            raw = src.read(dblk + prefix, n * esize)
            entries = [raw[i * esize:(i + 1) * esize] for i in range(n)]
        grid = [-(-m // c) for m, c in zip(self.maxshape, cshape)]
        table = {}
        for i, e in enumerate(entries):
            if e is None:
                continue
            a = src.addr(e, 0)
            if not src.defined(a):
                continue
            if client == 1:
                size = _u(e, O, esize - O - 4)
                mask = _u(e, esize - 4, 4)
            else:
                size, mask = full, 0
            table[tuple(int(x) for x in np.unravel_index(i, grid))] = (
                a, size, mask)
        return table

    def _chunk(self, coords, cshape, edge_raw) -> np.ndarray:
        """One chunk, decoded, as an array of the chunk's shape, or None
        where it was never written."""
        ent = self._chunk_table().get(coords)
        if ent is None:
            return None
        addr, size, mask = ent
        data = self._src.read(addr, size)
        stored = self._type.stored
        if not edge_raw:
            for i in reversed(range(len(self._filters))):
                if mask & (1 << i):
                    continue
                fid, _, vals = self._filters[i]
                if fid == 1:
                    data = zlib.decompress(data)
                else:
                    es = vals[0] if vals else stored.itemsize
                    data = _unshuffle(data, es)
        need = int(np.prod(cshape)) * stored.itemsize
        if len(data) != need:
            raise ValueError(f"{self._what}: chunk {coords} holds "
                             f"{len(data)} bytes, not {need}")
        return np.frombuffer(data, stored).reshape(cshape)

    # ------------------------------------------------------------ reading

    def _raw_rows(self, rows: np.ndarray) -> np.ndarray:
        """Stored elements of the sorted unique rows `rows` (rank >= 1)."""
        stored = self._type.stored
        tail = self.shape[1:]
        kind = self._storage[0]
        if kind == "compact":
            arr = np.frombuffer(self._storage[1], stored,
                                count=int(np.prod(self.shape)))
            return arr.reshape(self.shape)[rows]
        out = np.empty((len(rows),) + tail, stored)
        if kind == "contiguous":
            addr = self._storage[1]
            if not self._src.defined(addr) or len(rows) == 0:
                out[...] = self._fill
                return out
            row_bytes = int(np.prod(tail)) * stored.itemsize
            mv = memoryview(out.reshape(-1).view(np.uint8))
            breaks = np.nonzero(np.diff(rows) != 1)[0] + 1
            starts = np.concatenate([[0], breaks])
            ends = np.concatenate([breaks, [len(rows)]])
            for s, e in zip(starts.tolist(), ends.tolist()):
                if row_bytes:
                    self._src.read_into(mv[s * row_bytes:e * row_bytes],
                                        addr + int(rows[s]) * row_bytes)
            return out
        cshape, edge_raw_flag = self._storage[1], self._storage[2]
        c0 = cshape[0]
        grid_rest = [range(-(-n // c)) for n, c in zip(tail, cshape[1:])]
        which = rows // c0
        for r in np.unique(which).tolist():
            sel = np.nonzero(which == r)[0]
            slab = np.empty((c0,) + tail, stored)
            slab[...] = self._fill
            for rest in np.ndindex(*[len(g) for g in grid_rest]):
                coords = (r,) + tuple(rest)
                lo = [c * s for c, s in zip(coords, cshape)]
                edge = any(l + s > n for l, s, n in zip(lo, cshape,
                                                         self.shape))
                chunk = self._chunk(coords, cshape, edge and edge_raw_flag)
                if chunk is None:
                    continue
                region = tuple(slice(l, min(l + s, n)) for l, s, n in zip(
                    lo[1:], cshape[1:], tail))
                part = tuple(slice(0, min(l + s, n) - l) for l, s, n in zip(
                    lo, cshape, self.shape))
                slab[(slice(0, part[0].stop),) + region] = chunk[part]
            out[sel] = slab[rows[sel] - r * c0]
        return out

    def _decode(self, raw: np.ndarray) -> np.ndarray:
        """The caller's elements of stored ones: variable-length strings
        fetched from the global heap."""
        if not self._type.vlen:
            return raw
        flat = raw.reshape(-1)
        out = np.empty(flat.shape, object)
        lens = flat["n"].astype(np.int64)
        addrs = flat["addr"]
        idxs = flat["idx"]
        for a in np.unique(addrs[lens > 0]).tolist():
            objs = self._collection(int(a))
            for i in np.nonzero((addrs == a) & (lens > 0))[0].tolist():
                out[i] = bytes(objs[int(idxs[i])][:lens[i]])
        for i in np.nonzero(lens == 0)[0].tolist():
            out[i] = b""
        return out.reshape(raw.shape)

    def _collection(self, addr: int) -> dict:
        with self._lock:
            objs = self._heap.get(addr)
            if objs is not None:
                self._heap.move_to_end(addr)
                return objs
        objs = self._src.collection(addr)
        size = sum(len(v) for v in objs.values())
        with self._lock:
            if addr not in self._heap:
                self._heap[addr] = objs
                self._heap_bytes += size
                while (self._heap_bytes > self.HEAP_CACHE_BYTES
                       and len(self._heap) > 1):
                    _, old = self._heap.popitem(last=False)
                    self._heap_bytes -= sum(len(v) for v in old.values())
        return objs

    def _all(self) -> np.ndarray:
        if not self.shape:  # scalar
            kind = self._storage[0]
            stored = self._type.stored
            if kind == "compact":
                raw = np.frombuffer(self._storage[1], stored, count=1)
            elif kind == "contiguous" and self._src.defined(self._storage[1]):
                raw = np.frombuffer(self._src.read(self._storage[1],
                                                   stored.itemsize), stored)
            elif kind == "chunked":
                raise ValueError(f"{self._what}: a chunked scalar")
            else:
                raw = self._fill.reshape(1)
            return self._decode(raw.reshape(()))
        return self._decode(self._raw_rows(np.arange(self.shape[0])))

    def _rows(self, idx) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        if idx.ndim != 1:
            raise TypeError(f"{self._what}: index arrays must be 1-d")
        n = self.shape[0]
        idx = np.where(idx < 0, idx + n, idx)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"{self._what}: index out of range for {n} rows")
        if idx.size > 1 and np.all(np.diff(idx) > 0):
            return self._decode(self._raw_rows(idx))
        uniq, inv = np.unique(idx, return_inverse=True)
        return self._decode(self._raw_rows(uniq))[inv.reshape(-1)]

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 0:
            out = self._all()
            return out[()] if out.ndim == 0 else out
        if not self.shape:
            raise ValueError(f"{self._what}: a scalar dataset takes [()]")
        n = self.shape[0]
        if isinstance(key, (int, np.integer)):
            i = int(key) + (n if key < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"{self._what}: row {key} of {n}")
            return self._rows([i])[0]
        if isinstance(key, slice):
            return self._rows(np.arange(*key.indices(n)))
        arr = np.asarray(key)
        if isinstance(key, tuple) or arr.dtype.kind not in "iu":
            raise TypeError(f"{self._what}: index {key!r} is not supported")
        return self._rows(arr)

    def __array__(self, dtype=None, copy=None):
        out = self._all()
        return out if dtype is None else out.astype(dtype)

    def __len__(self):
        if not self.shape:
            raise TypeError(f"{self._what}: a scalar dataset has no len")
        return self.shape[0]


def _unshuffle(data: bytes, es: int) -> bytes:
    if es <= 1:
        return data
    n = len(data) // es
    body = np.frombuffer(data, np.uint8, count=n * es)
    out = body.reshape(es, n).T.tobytes()
    return out + data[n * es:]


# ------------------------------------------------------------------ writing

_LEAF_K, _INT_K = 4, 16  # symbol nodes of 8 entries, B-tree nodes of 32
_O = 8


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _p8(x: int) -> bytes:
    return struct.pack("<Q", x)


def _header_v1(msgs) -> bytes:
    """A v1 object header of (type, body) messages, each padded to 8."""
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(m)), 0) + _pad8(m)
                    for t, m in msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


def _dtype_message(dt: np.dtype) -> bytes:
    order = 1 if dt.byteorder == ">" else 0
    size = dt.itemsize
    if dt.kind in "iu":
        bits = order | (0x08 if dt.kind == "i" else 0)
        return (struct.pack("<B3sI", 0x10, bits.to_bytes(3, "little"), size)
                + struct.pack("<HH", 0, 8 * size))
    prec, eloc, esize, mloc, msize, bias = _IEEE[size]
    bits = order | 0x20 | ((8 * size - 1) << 8)
    return (struct.pack("<B3sI", 0x11, bits.to_bytes(3, "little"), size)
            + struct.pack("<HHBBBBI", 0, prec, eloc, esize, mloc, msize,
                          bias))


# variable-length UTF-8 string over 1-byte unsigned characters
_VLEN_STR_TYPE = (struct.pack("<B3sI", 0x19, (0x01 | (1 << 8)).to_bytes(
    3, "little"), 4 + _O + 4) + struct.pack("<B3sIHH", 0x10, bytes(3), 1, 0,
                                             8))


class _WGroup:
    def __init__(self, w, name):
        self._w, self.name, self.links = w, name, {}

    def keys(self):
        return list(self.links)

    def __contains__(self, name):
        return name in self.links

    def __getitem__(self, path):
        node = self
        for part in [p for p in path.split("/") if p]:
            node = node.links[part]
            if not isinstance(node, _WGroup):
                raise KeyError(f"{path!r}: written datasets are not read "
                               "back through a file open for writing")
        return node

    def _parent(self, path):
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"bad name {path!r}")
        node = self
        for part in parts[:-1]:
            node = node.links.get(part) or node.create_group(part)
        if parts[-1] in node.links:
            raise ValueError(f"{node.name}/{parts[-1]} already exists")
        return node, parts[-1]

    def create_group(self, path):
        node, leaf = self._parent(path)
        g = node.links[leaf] = _WGroup(self._w,
                                       node.name.rstrip("/") + "/" + leaf)
        return g

    def create_dataset(self, path, data=None, dtype=None):
        node, leaf = self._parent(path)
        node.links[leaf] = self._w.dataset(data, dtype,
                                           node.name.rstrip("/") + "/" + leaf)


class _Writer:
    """Writes data and dataset headers as they come, then at close the
    groups (local heap, symbol nodes, B-tree, header) from the leaves up,
    and last the superblock."""

    SUPERBLOCK = 96

    def __init__(self, path):
        self.path = str(path)
        self.f = open(self.path, "w+b")
        self.eof = self.SUPERBLOCK
        self.root = _WGroup(self, "/")

    def alloc(self, data: bytes) -> int:
        addr = self.eof
        self.f.seek(addr)
        self.f.write(data)
        self.eof += len(data) + (-len(data) % 8)
        return addr

    def dataset(self, data, dtype, name) -> int:
        """Write one dataset's elements and header; its header address."""
        if dtype is not None:
            vlen = np.dtype(dtype).kind == "O"
        else:
            vlen = np.asarray(data).dtype.kind in "OU"
        if vlen:
            arr = np.asarray(data, dtype=object)
            raw = self._strings(arr.reshape(-1))
            shape, tmsg = arr.shape, _VLEN_STR_TYPE
        else:
            arr = np.asarray(data) if dtype is None else np.asarray(
                data, dtype=dtype)
            if arr.dtype.kind not in "iuf" or (
                    arr.dtype.kind == "f" and arr.itemsize not in _IEEE) or (
                    arr.itemsize not in (1, 2, 4, 8)):
                raise TypeError(f"{self.path}:{name}: dtype {arr.dtype} is "
                                "not supported by this writer")
            raw = np.ascontiguousarray(arr).tobytes()
            shape, tmsg = arr.shape, _dtype_message(arr.dtype)
        if raw:
            addr, size = self.alloc(raw), len(raw)
        else:
            addr, size = _UNDEF, 0
        space = (struct.pack("<BBBB4x", 1, len(shape), 1 if shape else 0, 0)
                 + b"".join(_p8(d) for d in shape)
                 + (b"".join(_p8(d) for d in shape) if shape else b""))
        fill = struct.pack("<BBBB", 2, 2, 2, 0)
        layout = struct.pack("<BB", 3, 1) + _p8(addr) + _p8(size)
        return self.alloc(_header_v1([(0x0001, space), (0x0003, tmsg),
                                      (0x0005, fill), (0x0008, layout)]))

    def _strings(self, values) -> bytes:
        """Each string as a global-heap object, in collections of at least
        4096 bytes; the 16-byte (length, collection, index) elements."""
        encoded = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
                   for v in values]
        elems = []
        batch: list = []
        used = 16

        def flush():
            if not batch:
                return
            objs = b"".join(struct.pack("<HHIQ", i + 1, 0, 0, len(s))
                            + _pad8(s) for i, s in enumerate(batch))
            size = max(4096, 16 + len(objs) + 16)
            free = size - 16 - len(objs)
            body = (b"GCOL" + bytes([1, 0, 0, 0]) + _p8(size) + objs
                    + struct.pack("<HHIQ", 0, 0, 0, free)
                    + bytes(free - 16))
            addr = self.alloc(body)
            for i, s in enumerate(batch):
                elems.append(struct.pack("<IQI", len(s), addr, i + 1))
            batch.clear()

        for s in encoded:
            need = 16 + len(s) + (-len(s) % 8)
            if batch and (used + need + 16 > 4096 or len(batch) >= 0xFFFE):
                flush()
                used = 16
            batch.append(s)
            used += need
        flush()
        return b"".join(elems)

    def _group(self, g: _WGroup) -> tuple:
        """Write `g` and its subgroups: (header address, B-tree, heap)."""
        links = {}
        for name, target in g.links.items():
            links[name.encode("utf-8")] = (self._group(target)[0]
                                           if isinstance(target, _WGroup)
                                           else target)
        names = sorted(links)
        heap = bytearray(8)  # "" at offset 0: the first key's name
        offs = {}
        for n in names:
            offs[n] = len(heap)
            heap += _pad8(n + b"\0")
        heap_addr = self.alloc(b"HEAP" + bytes(4) + _p8(len(heap)) + _p8(1)
                               + _p8(self.eof + 32) + bytes(heap))
        # symbol nodes of up to 2K entries, then B-tree levels of up to
        # 2K children: each entry (the children's addresses, the last name
        # of each child's subtree)
        leaf_cap, node_cap = 2 * _LEAF_K, 2 * _INT_K
        level = []
        for s in range(0, len(names), leaf_cap):
            part = names[s:s + leaf_cap]
            body = b"".join(_p8(offs[n]) + _p8(links[n]) + bytes(24)
                            for n in part)
            body += bytes((leaf_cap - len(part)) * 40)
            addr = self.alloc(b"SNOD" + struct.pack("<BBH", 1, 0, len(part))
                              + body)
            level.append((addr, offs[part[-1]]))
        depth = 0
        node_size = 24 + (2 * node_cap + 1) * 8
        while True:
            groups = [level[s:s + node_cap]
                      for s in range(0, len(level), node_cap)] or [[]]
            addrs = [self.alloc(bytes(node_size)) for _ in groups]
            left_key = 0
            up = []
            for i, (addr, ch) in enumerate(zip(addrs, groups)):
                left = addrs[i - 1] if i else _UNDEF
                right = addrs[i + 1] if i + 1 < len(addrs) else _UNDEF
                body = _p8(left_key)
                for child, last in ch:
                    body += _p8(child) + _p8(last)
                node = (b"TREE" + struct.pack("<BBH", 0, depth, len(ch))
                        + _p8(left) + _p8(right) + body)
                self.f.seek(addr)
                self.f.write(node)
                if ch:
                    left_key = ch[-1][1]
                up.append((addr, left_key))
            if len(addrs) == 1:
                btree = addrs[0]
                break
            level, depth = up, depth + 1
        stab = _p8(btree) + _p8(heap_addr)
        return self.alloc(_header_v1([(0x0011, stab)])), btree, heap_addr

    def close(self):
        if self.f is None:
            return
        try:
            root, btree, heap = self._group(self.root)
            eof = self.eof
            sb = (_SIGNATURE + bytes([0, 0, 0, 0, 0, _O, _O, 0])
                  + struct.pack("<HHI", _LEAF_K, _INT_K, 0)
                  + _p8(0) + _p8(_UNDEF) + _p8(eof) + _p8(_UNDEF)
                  + _p8(0) + _p8(root) + struct.pack("<II", 1, 0)
                  + _p8(btree) + _p8(heap))
            self.f.seek(0)
            self.f.write(sb)
            self.f.truncate(eof)
        finally:
            self.f.close()
            self.f = None


class File:
    """An HDF5 file: `File(path)` (or mode "r") reads, `File(path, "w")`
    writes a new one. A context manager; in read mode `keys()`, `in`,
    `[path]` as a Group; in write mode `create_group` and
    `create_dataset(name, data=, dtype=None | STRING)` as well."""

    def __init__(self, path, mode: str = "r"):
        self.mode = mode
        if mode == "r":
            self._src = _Source(path)
            self._root = self._src.node(self._src.root, "/")
        elif mode == "w":
            self._writer = _Writer(path)
            self._root = self._writer.root
        else:
            raise ValueError(f"mode {mode!r}: 'r' or 'w'")

    def keys(self):
        return self._root.keys()

    def __contains__(self, path):
        return path in self._root

    def __getitem__(self, path):
        return self._root[path]

    def create_group(self, path):
        return self._root.create_group(path)

    def create_dataset(self, path, data=None, dtype=None):
        return self._root.create_dataset(path, data=data, dtype=dtype)

    def close(self):
        if self.mode == "w":
            self._writer.close()
        else:
            self._src.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
