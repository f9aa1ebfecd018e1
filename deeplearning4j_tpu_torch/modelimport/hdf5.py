"""A read-only HDF5 reader for the files that Keras and h5py write with
their default settings, without h5py.

The Keras importer (``modelimport/keras.py``) reads a model file through a
small part of h5py's surface: ``File(path)`` as a context manager,
``.attrs`` as a mapping, ``group[name]``, iteration over a group's members
in h5py's order (by name), ``isinstance(item, Dataset)`` and ``ds[()]`` or
``np.asarray(ds)``. This module gives that surface over the file format as
HDF5's library writes it with ``libver="earliest"`` (h5py's default):

* superblock version 0 or 1;
* version-1 object headers, with continuation blocks;
* groups stored as symbol tables: a version-1 B-tree of type 0 at any
  depth, its symbol-table nodes (``SNOD``) and the group's local heap;
* attribute messages of versions 1-3;
* datatypes: fixed-point and IEEE floating point (f16, f32, f64) of either
  byte order, fixed-length strings and variable-length strings (kept in
  global-heap collections), scalar or in arrays;
* dataspaces of versions 1-2, scalar and simple;
* data-layout messages of version 3, contiguous or compact. Storage never
  allocated (an undefined address, as for a dataset created and never
  written) reads as the fill value (messages 0x0004 and 0x0005), or as zeros
  where the file gives none.

Values come back as h5py returns them: an attribute's variable-length
string as ``str`` (an object array of ``str`` for an array), a dataset's as
``bytes``; a fixed-length string as ``numpy.bytes_`` (``S`` arrays); a
scalar number as a numpy scalar; byte order as stored.

Anything else raises :class:`UnsupportedHDF5Error`, naming the object and
the feature (chunked layout, filters, new-style link groups, dense
attribute storage, superblock version 2 or later, ...): the reader never
returns an array it cannot read exactly.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object-header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS, _ATTRIBUTE = 0x6, 0x7, 0x8, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

# IEEE layouts: size -> (precision, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias)
_IEEE = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127), 8: (64, 52, 11, 0, 52, 1023)}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                8: "enumerated (h5py's bool)", 10: "array"}


class UnsupportedHDF5Error(NotImplementedError):
    """The file uses a feature outside the reader's subset."""

    def __init__(self, path: str, feature: str) -> None:
        super().__init__(f"HDF5 object {path!r}: {feature} is not supported by this reader "
                         "(it reads files written with libver='earliest': symbol-table groups, "
                         "contiguous or compact datasets without filters)")
        self.path, self.feature = path, feature


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Type:
    """A datatype: ``kind`` "num" (``dtype`` a numpy dtype), "str" (fixed
    length, ``dtype`` ``S<size>``) or "vstr" (variable length)."""

    def __init__(self, kind: str, size: int, dtype: Optional[np.dtype] = None) -> None:
        self.kind, self.size, self.dtype = kind, size, dtype

    @property
    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object) if self.kind == "vstr" else self.dtype


class _Reader:
    """The file's bytes and the format's primitives."""

    def __init__(self, buf: bytes) -> None:
        self.buf = memoryview(buf)
        self._heaps: Dict[int, Dict[int, bytes]] = {}
        at = 0
        while at + 8 <= len(buf) and bytes(self.buf[at:at + 8]) != SIGNATURE:
            at = 512 if at == 0 else at * 2  # a user block shifts the superblock
        if at + 8 > len(buf):
            raise ValueError("not an HDF5 file (no superblock signature)")
        version = self.buf[at + 8]
        if version > 1:
            raise UnsupportedHDF5Error(
                "/", f"superblock version {version} (a file written with libver='latest' or "
                "a 1.10+ format)")
        self.O, self.L = self.buf[at + 13], self.buf[at + 14]
        pos = at + (24 if version == 0 else 28)
        self.base = self.u(pos, self.O)
        pos += 4 * self.O  # base, free-space, end-of-file and driver addresses
        self.root = self.addr(pos + self.O)  # the root symbol-table entry's object header

    def u(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def addr(self, pos: int) -> Optional[int]:
        """The address at ``pos``, or None where it is undefined (all ones)."""
        v = self.u(pos, self.O)
        return None if v == (1 << (8 * self.O)) - 1 else v + self.base

    def sig(self, pos: int, sig: bytes, path: str, what: str) -> None:
        if bytes(self.buf[pos:pos + 4]) != sig:
            raise ValueError(f"HDF5 object {path!r}: no {what} at {pos} (corrupt file)")

    # ---- object headers -------------------------------------------------------
    def messages(self, addr: int, path: str) -> List[Tuple[int, int, memoryview]]:
        """(type, flags, data) of every message of the version-1 object
        header at ``addr``, continuation blocks followed."""
        b = self.buf
        if bytes(b[addr:addr + 4]) == b"OHDR":
            raise UnsupportedHDF5Error(path, "a version-2 object header (libver='latest')")
        if b[addr] != 1:
            raise UnsupportedHDF5Error(path, f"object header version {b[addr]}")
        blocks = [(addr + 16, self.u(addr + 8, 4))]
        out = []
        while blocks:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end:
                mtype, msize, flags = self.u(pos, 2), self.u(pos + 2, 2), b[pos + 4]
                data = b[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((self.u_addr(data, 0),
                                   int.from_bytes(data[self.O:self.O + self.L], "little")))
                elif mtype != _NIL:
                    if flags & 0x02:
                        raise UnsupportedHDF5Error(path, f"a shared message (type {mtype:#x})")
                    out.append((mtype, flags, data))
        return out

    def u_addr(self, data: memoryview, pos: int) -> Optional[int]:
        v = int.from_bytes(data[pos:pos + self.O], "little")
        return None if v == (1 << (8 * self.O)) - 1 else v + self.base

    # ---- datatypes, dataspaces, values ----------------------------------------
    def datatype(self, d: memoryview, path: str) -> _Type:
        cls, version = d[0] & 0x0F, d[0] >> 4
        bits = d[1] | d[2] << 8 | d[3] << 16
        size = int.from_bytes(d[4:8], "little")
        if version not in (1, 2, 3):
            raise UnsupportedHDF5Error(path, f"datatype message version {version}")
        order = ">" if bits & 1 else "<"
        if cls == 0:
            off, prec = int.from_bytes(d[8:10], "little"), int.from_bytes(d[10:12], "little")
            if size not in (1, 2, 4, 8) or off or prec != 8 * size or bits & 0x6:
                raise UnsupportedHDF5Error(path, f"a {prec}-bit integer at offset {off} in "
                                                 f"{size} bytes (padding {bits & 6:#x})")
            return _Type("num", size, np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"))
        if cls == 1:
            layout = (int.from_bytes(d[10:12], "little"), d[12], d[13], d[14], d[15],
                      int.from_bytes(d[16:20], "little"))
            off, sign = int.from_bytes(d[8:10], "little"), (bits >> 8) & 0xFF
            if (size not in _IEEE or layout != _IEEE[size] or off or bits & 0x40
                    or (bits >> 4) & 3 != 2 or bits & 0xE or sign != 8 * size - 1):
                raise UnsupportedHDF5Error(path, f"a non-IEEE {size}-byte float "
                                                 f"(layout {layout}, bits {bits:#x})")
            return _Type("num", size, np.dtype(f"{order}f{size}"))
        if cls == 3:
            return _Type("str", size, np.dtype(f"S{size}"))
        if cls == 9:
            if bits & 0xF != 1:
                raise UnsupportedHDF5Error(path, "a variable-length sequence (not a string)")
            return _Type("vstr", size)
        raise UnsupportedHDF5Error(path, f"datatype class {cls} "
                                         f"({_CLASS_NAMES.get(cls, 'unknown')})")

    def dataspace(self, d: memoryview, path: str) -> Tuple[int, ...]:
        version, rank = d[0], d[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if d[3] == 2:
                raise UnsupportedHDF5Error(path, "a null dataspace (h5py.Empty)")
            pos = 4
        else:
            raise UnsupportedHDF5Error(path, f"dataspace message version {version}")
        return tuple(int.from_bytes(d[pos + i * self.L:pos + (i + 1) * self.L], "little")
                     for i in range(rank))

    def values(self, typ: _Type, shape: Tuple[int, ...], raw, path: str) -> np.ndarray:
        """The array of ``shape`` stored in ``raw``; variable-length strings
        as an object array of ``bytes``."""
        n = int(np.prod(shape, dtype=np.int64))
        if typ.kind != "vstr":
            if len(raw) < n * typ.size:
                raise ValueError(f"HDF5 object {path!r}: {len(raw)} bytes of data for "
                                 f"{n} x {typ.size} (corrupt file)")
            return np.frombuffer(raw, typ.dtype, count=n).reshape(shape).copy()
        out = np.empty(n, dtype=object)
        for i in range(n):
            p = i * typ.size
            length = int.from_bytes(raw[p:p + 4], "little")
            coll = self.u_addr(raw, p + 4)
            index = int.from_bytes(raw[p + 4 + self.O:p + 8 + self.O], "little")
            out[i] = b"" if coll is None else self.global_heap(coll, path)[index][:length]
        return out.reshape(shape)

    def global_heap(self, addr: int, path: str) -> Dict[int, bytes]:
        if addr not in self._heaps:
            self.sig(addr, b"GCOL", path, "global heap collection")
            end = addr + self.u(addr + 8, self.L)
            pos, objs = addr + 8 + self.L, {}
            while pos + 8 + self.L <= end:
                index, size = self.u(pos, 2), self.u(pos + 8, self.L)
                if index == 0:  # the free space closes the collection
                    break
                objs[index] = bytes(self.buf[pos + 8 + self.L:pos + 8 + self.L + size])
                pos += 8 + self.L + _pad8(size)
            self._heaps[addr] = objs
        return self._heaps[addr]

    # ---- groups --------------------------------------------------------------
    def symbol_table(self, btree: int, heap: int, path: str) -> Dict[str, int]:
        """{member name: object header address} of an old-style group."""
        self.sig(heap, b"HEAP", path, "local heap")
        data = self.addr(heap + 8 + 2 * self.L)
        out: Dict[str, int] = {}
        stack = [btree]
        while stack:
            node = stack.pop()
            if bytes(self.buf[node:node + 4]) == b"SNOD":
                n = self.u(node + 6, 2)
                size = 2 * self.O + 24
                for i in range(n):
                    e = node + 8 + i * size
                    name_off, header = self.u(e, self.O), self.addr(e + self.O)
                    name = self.cstring(data + name_off)
                    if self.u(e + 2 * self.O, 4) == 2:
                        raise UnsupportedHDF5Error(f"{path.rstrip('/')}/{name}", "a soft link")
                    out[name] = header
                continue
            self.sig(node, b"TREE", path, "v1 B-tree node")
            if self.buf[node + 4] != 0:
                raise ValueError(f"HDF5 object {path!r}: a B-tree of type {self.buf[node + 4]} "
                                 "under a group (corrupt file)")
            entries = self.u(node + 6, 2)
            pos = node + 8 + 2 * self.O + self.L  # past the siblings and key 0
            for _ in range(entries):
                stack.append(self.addr(pos))
                pos += self.O + self.L
        return out

    def cstring(self, pos: int) -> str:
        end = pos
        while self.buf[end]:
            end += 1
        return bytes(self.buf[pos:end]).decode()


def _attribute(r: _Reader, d: memoryview, path: str) -> Tuple[str, object]:
    version = d[0]
    if version not in (1, 2, 3):
        raise UnsupportedHDF5Error(path, f"attribute message version {version}")
    if version > 1 and d[1] & 0x3:
        raise UnsupportedHDF5Error(path, "an attribute with a shared datatype or dataspace")
    sizes = [int.from_bytes(d[i:i + 2], "little") for i in (2, 4, 6)]
    pos = 8 if version < 3 else 9
    parts = []
    for s in sizes:
        parts.append(d[pos:pos + s])
        pos += _pad8(s) if version == 1 else s
    name = bytes(parts[0]).split(b"\0", 1)[0].decode()
    where = f"{path.rstrip('/')}@{name}" if path != "/" else f"/@{name}"
    typ = r.datatype(parts[1], where)
    shape = r.dataspace(parts[2], where)
    arr = r.values(typ, shape, d[pos:], where)
    if typ.kind == "vstr":  # h5py returns attributes' variable-length strings as str
        arr = np.array([v.decode() for v in arr.reshape(-1)], dtype=object).reshape(shape)
    return name, arr[()] if shape == () else arr


class HLObject:
    """A group or dataset: its path, its attributes and its messages."""

    def __init__(self, reader: _Reader, addr: int, name: str, msgs=None) -> None:
        self._r, self._addr, self.name = reader, addr, name
        self._msgs = reader.messages(addr, name) if msgs is None else msgs
        self._attrs: Optional[Dict[str, object]] = None

    @property
    def attrs(self) -> Dict[str, object]:
        """The attributes by name (a plain dict, in name order)."""
        if self._attrs is None:
            attrs = {}
            for mtype, _, data in self._msgs:
                if mtype == _ATTRIBUTE:
                    k, v = _attribute(self._r, data, self.name)
                    attrs[k] = v
                elif mtype == _ATTRIBUTE_INFO:
                    heap = self._r.u_addr(data, 2 + (2 if data[1] & 1 else 0))
                    if heap is not None:
                        raise UnsupportedHDF5Error(self.name, "dense attribute storage")
            self._attrs = dict(sorted(attrs.items()))
        return self._attrs

    def _message(self, mtype: int) -> Optional[memoryview]:
        return next((d for t, _, d in self._msgs if t == mtype), None)


class Dataset(HLObject):
    """A dataset: ``shape``, ``dtype``, ``ds[()]`` and ``np.asarray(ds)``."""

    def __init__(self, reader: _Reader, addr: int, name: str, msgs) -> None:
        super().__init__(reader, addr, name, msgs)
        for mtype, feature in ((_FILTERS, "a filter pipeline (compression or checksums)"),
                               (_EXTERNAL, "external storage")):
            if self._message(mtype) is not None:
                raise UnsupportedHDF5Error(name, feature)
        self._type = reader.datatype(self._message(_DATATYPE), name)
        self.shape = reader.dataspace(self._message(_DATASPACE), name)
        self.dtype = self._type.numpy_dtype
        layout = self._message(_LAYOUT)
        if layout[0] != 3:
            raise UnsupportedHDF5Error(name, f"data layout message version {layout[0]}")
        self._layout = layout
        if layout[1] not in (0, 1):
            raise UnsupportedHDF5Error(
                name, {2: "chunked layout", 3: "virtual layout"}.get(layout[1],
                                                                     f"layout class {layout[1]}"))
        self._assigned: Optional[np.ndarray] = None

    @property
    def allocated(self) -> bool:
        """Whether the file holds the dataset's storage (compact data
        always; contiguous data at a defined address)."""
        return self._layout[1] == 0 or self._r.u_addr(self._layout, 2) is not None

    def assign(self, values) -> None:
        """Serve ``values`` (this shape and dtype) in place of the stored
        data; the file is not written. A skeleton file, whose datasets were
        created and never written, gets its weights this way."""
        arr = np.asarray(values)
        if arr.shape != self.shape or arr.dtype != self.dtype:
            raise ValueError(f"{self.name}: assigning {arr.dtype}{list(arr.shape)} to "
                             f"{self.dtype}{list(self.shape)}")
        self._assigned = arr

    def _read(self) -> np.ndarray:
        if self._assigned is not None:
            return self._assigned.copy()
        r, layout = self._r, self._layout
        if layout[1] == 0:  # compact: the data lies in the message
            n = int.from_bytes(layout[2:4], "little")
            return r.values(self._type, self.shape, layout[4:4 + n], self.name)
        addr = r.u_addr(layout, 2)
        if addr is not None:
            n = int.from_bytes(layout[2 + r.O:2 + r.O + r.L], "little")
            return r.values(self._type, self.shape, r.buf[addr:addr + n], self.name)
        return self._fill()

    def _fill(self) -> np.ndarray:
        """The fill value's array, for storage never allocated."""
        value = None
        new, old = self._message(_FILL), self._message(_FILL_OLD)
        if new is not None:
            version = new[0]
            if version in (1, 2) and (version == 1 or new[3] != 0):
                n = int.from_bytes(new[4:8], "little")
                value = new[8:8 + n] if n else None
            elif version == 3 and new[1] & 0x20:
                n = int.from_bytes(new[2:6], "little")
                value = new[6:6 + n] if n else None
            elif version not in (1, 2, 3):
                raise UnsupportedHDF5Error(self.name, f"fill value message version {version}")
        elif old is not None:
            n = int.from_bytes(old[0:4], "little")
            value = old[4:4 + n] if n else None
        if self._type.kind == "vstr":
            if value is not None:
                raise UnsupportedHDF5Error(self.name, "a variable-length string fill value")
            return np.full(self.shape, b"", dtype=object)
        if value is None:
            return np.zeros(self.shape, self._type.dtype)
        return np.full(self.shape, np.frombuffer(value, self._type.dtype, count=1)[0],
                       self._type.dtype)

    def __getitem__(self, key):
        return self._read()[key]  # ds[()] of a scalar: a numpy scalar, as h5py gives

    def __array__(self, dtype=None, copy=None):
        arr = self._read()
        return arr if dtype is None else arr.astype(dtype)


class Group(HLObject):
    """A group: a mapping from member names to groups and datasets,
    iterated in name order as h5py does."""

    def __init__(self, reader: _Reader, addr: int, name: str, msgs=None) -> None:
        super().__init__(reader, addr, name, msgs)
        if self._message(_LINK_INFO) is not None or self._message(_LINK) is not None:
            raise UnsupportedHDF5Error(name, "a new-style (link-message) group")
        table = self._message(_SYMBOL_TABLE)
        if table is None:
            raise UnsupportedHDF5Error(name, "an object that is neither a symbol-table group "
                                             "nor a dataset (a committed datatype?)")
        members = reader.symbol_table(reader.u_addr(table, 0), reader.u_addr(table, reader.O),
                                      name)
        self._members = dict(sorted(members.items(), key=lambda kv: kv[0].encode()))
        self._cache: Dict[str, HLObject] = {}

    def _child(self, key: str) -> HLObject:
        if key not in self._cache:
            if key not in self._members:
                raise KeyError(f"Unable to open object (object {key!r} doesn't exist in "
                               f"{self.name!r})")
            addr = self._members[key]
            path = f"{self.name.rstrip('/')}/{key}"
            msgs = self._r.messages(addr, path)
            is_dataset = any(t == _LAYOUT for t, _, _ in msgs)
            self._cache[key] = (Dataset if is_dataset else Group)(self._r, addr, path, msgs)
        return self._cache[key]

    def __getitem__(self, key: str) -> HLObject:
        obj: HLObject = self
        for part in (p for p in key.split("/") if p):
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name!r} is a dataset, not a group")
            obj = obj._child(part)
        return obj

    def __contains__(self, key) -> bool:
        try:
            self[key]
        except KeyError:
            return False
        return True

    def __iter__(self) -> Iterator[str]:
        return iter(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def visititems(self, fn):
        """Call ``fn(name, obj)`` for every object below this group, depth
        first in name order (h5py's ``visititems``); stop at a non-None
        return and return it."""
        for k in self._members:
            obj = self[k]
            rel = obj.name[len(self.name.rstrip("/")) + 1:]
            res = fn(rel, obj)
            if res is not None:
                return res
            if isinstance(obj, Group):
                res = obj.visititems(lambda n, o, rel=rel: fn(f"{rel}/{n}", o))
                if res is not None:
                    return res
        return None


class File(Group):
    """An HDF5 file opened for reading, from a path or from its bytes;
    also its root group."""

    def __init__(self, source: Union[str, os.PathLike, bytes, bytearray, memoryview]) -> None:
        if isinstance(source, (bytes, bytearray, memoryview)):
            buf, self.filename = bytes(source), "<bytes>"
        else:
            with open(source, "rb") as f:
                buf = f.read()
            self.filename = os.fspath(source)
        reader = _Reader(buf)
        super().__init__(reader, reader.root, "/")

    def datasets(self) -> List[Dataset]:
        """Every dataset in the file, in path order."""
        out: List[Dataset] = []
        self.visititems(lambda n, o: out.append(o) if isinstance(o, Dataset) else None)
        return sorted(out, key=lambda d: d.name)

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        """Nothing to release: the file's bytes (and any values put in place
        by ``Dataset.assign``) live as long as the File."""
