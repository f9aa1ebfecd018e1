"""The port's HDF5 reader (``modelimport/hdf5.py``) against h5py.

Each file is written here by h5py with its default settings
(``libver="earliest"``) or by Keras, read by both, and every attribute and
dataset compared: value, dtype and type as h5py returns them. Then the
features outside the reader's subset (chunked layout, filters, a
``libver="latest"`` file, h5py's bool enum, a null dataspace) each raise
:class:`UnsupportedHDF5Error` naming the object and the feature.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu_torch.modelimport import hdf5  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.hdf5 import UnsupportedHDF5Error  # noqa: E402

NUMERIC = ["<i1", "<i2", "<i4", "<i8", "<u1", "<u2", "<u4", "<u8", "<f2", "<f4", "<f8",
           ">i2", ">i4", ">i8", ">u4", ">f2", ">f4", ">f8"]


def _same(ours, theirs, where):
    assert type(ours) is type(theirs), (where, type(ours), type(theirs))
    if isinstance(theirs, np.ndarray):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, where
        assert np.array_equal(ours, theirs), where
        if theirs.dtype == object:
            assert [type(v) for v in ours.reshape(-1)] == [type(v) for v in theirs.reshape(-1)]
    elif isinstance(theirs, np.generic):
        assert ours.dtype == theirs.dtype and ours == theirs, where
    else:
        assert ours == theirs, where


def assert_same_file(path_or_bytes, path):
    """Every group's members and attributes and every dataset equal h5py's."""
    ours = hdf5.File(path_or_bytes)
    n = [0]
    with h5py.File(path, "r") as theirs:
        def check(name, obj):
            mine = ours[name]
            for k, v in obj.attrs.items():
                _same(mine.attrs[k], v, f"{name}@{k}")
            assert list(mine.attrs) == sorted(obj.attrs)
            if isinstance(obj, h5py.Dataset):
                assert isinstance(mine, hdf5.Dataset) and mine.shape == obj.shape
                assert mine.dtype == obj.dtype
                _same(mine[()], obj[()], name)
                n[0] += 1
            else:
                assert isinstance(mine, hdf5.Group) and list(mine) == list(obj)

        for k, v in theirs.attrs.items():
            _same(ours.attrs[k], v, f"/@{k}")
        assert list(ours) == list(theirs)
        theirs.visititems(check)
    return n[0]


def test_numeric_datasets_and_attributes(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "num.h5"
    with h5py.File(path, "w") as f:
        for dt in NUMERIC:
            arr = (rng.standard_normal((3, 4)) * 50).astype(dt)
            f.create_dataset(f"arr_{dt}", data=arr)
            f.create_dataset(f"scalar_{dt}", data=arr[1, 2])
            f.create_dataset(f"vec_{dt}", data=arr[0])
            f.attrs[f"a_{dt}"] = arr[:2]
            f.attrs[f"s_{dt}"] = arr[2, 3]
        f.create_dataset("empty", data=np.zeros((0, 3), np.float32))
        f.create_dataset("rank4", data=rng.standard_normal((2, 3, 4, 5)).astype(np.float32))
    assert assert_same_file(str(path), path) == 3 * len(NUMERIC) + 2
    ours = hdf5.File(path)
    assert ours["vec_>f8"].dtype == np.dtype(">f8")  # byte order as stored
    assert np.asarray(ours["rank4"]).shape == (2, 3, 4, 5)


def test_strings(tmp_path):
    path = tmp_path / "str.h5"
    vlen = h5py.string_dtype()
    with h5py.File(path, "w") as f:
        f.attrs["vlen_scalar"] = "a variable-length string, ünïcode"
        f.attrs["vlen_array"] = np.array(["conv1/kernel", "conv1/bias", ""], dtype=object)
        f.attrs["vlen_2d"] = np.array([["a", "bb"], ["ccc", "d"]], dtype=object)
        f.attrs["fixed_scalar"] = np.bytes_(b"fixed")
        f.attrs["fixed_array"] = np.array([b"ab", b"cde", b""], dtype="S3")
        f.attrs.create("fixed_spaces", np.array([b"x  "], "S3"))
        f.attrs["long_json"] = '{"k": "' + "v" * 200_000 + '"}'  # a large heap object
        f.create_dataset("vlen_ds", data=np.array(["x", "yy", "zzz"], dtype=object), dtype=vlen)
        f.create_dataset("vlen_scalar_ds", data="one", dtype=vlen)
        f.create_dataset("fixed_ds", data=np.array([b"abc", b"d"], dtype="S4"))
    assert assert_same_file(path.read_bytes(), path) == 3
    ours = hdf5.File(path)
    assert isinstance(ours.attrs["vlen_scalar"], str)
    assert ours.attrs["vlen_array"].dtype == object and ours["vlen_ds"][()][1] == b"yy"


def test_nested_groups_and_iteration_order(tmp_path):
    path = tmp_path / "nested.h5"
    with h5py.File(path, "w") as f:
        for name in ("zeta", "alpha", "Beta", "a-b", "a_b", "a"):
            g = f.create_group(name)
            g.attrs["name"] = name
        deep = f.create_group("alpha/one/two/three")
        deep.create_dataset("leaf", data=np.arange(6.0).reshape(2, 3))
        f["a"].create_dataset("x", data=np.int64(7))
    assert assert_same_file(str(path), path) == 2
    ours = hdf5.File(path)
    assert list(ours) == ["Beta", "a", "a-b", "a_b", "alpha", "zeta"]
    assert "alpha/one/two" in ours and "alpha/nope" not in ours
    assert ours["alpha"]["one/two/three/leaf"][1, 2] == 5.0
    seen = []
    ours.visititems(lambda n, o: seen.append(n))
    h5 = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: h5.append(n))
    assert seen == h5


def _btree_level(f: hdf5.Group) -> int:
    """The level of the root node of a group's B-tree (0: one node)."""
    r = f._r
    table = f._message(0x11)
    return r.buf[r.u_addr(table, 0) + 5]


def test_group_over_256_members_two_btree_levels(tmp_path):
    path = tmp_path / "wide.h5"
    names = [f"layer_{i:04d}" for i in range(600)]
    rng = np.random.default_rng(1)
    with h5py.File(path, "w") as f:
        for n in rng.permutation(names):
            f.create_group(n).attrs["i"] = int(n[-4:])
        f.create_group("small")
    ours = hdf5.File(path)
    assert list(ours) == sorted(names + ["small"])
    assert _btree_level(ours) >= 1 and _btree_level(ours["small"]) == 0
    assert all(ours[n].attrs["i"] == int(n[-4:]) for n in names)
    assert_same_file(str(path), path)


def test_continuation_block(tmp_path):
    path = tmp_path / "cont.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("d", data=np.arange(4, dtype=np.float32))
        for i in range(60):  # outgrows the header's first block
            d.attrs[f"attr_{i:02d}"] = np.arange(i, dtype=np.int32)
    ours = hdf5.File(path)
    r = ours._r
    addr = ours._members["d"]
    first = [r.u(pos, 2) for pos in _first_block_message_positions(r, addr)]
    assert 0x10 in first  # a continuation message leads to the rest
    assert len(ours["d"].attrs) == 60
    assert_same_file(str(path), path)


def _first_block_message_positions(r, addr):
    pos, end = addr + 16, addr + 16 + r.u(addr + 8, 4)
    while pos + 8 <= end:
        yield pos
        pos += 8 + r.u(pos + 2, 2)


def test_unallocated_datasets_read_their_fill_value(tmp_path):
    path = tmp_path / "fill.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("zeros_f4", (3, 4), "f4")
        f.create_dataset("fill_f8", (5,), "f8", fillvalue=2.5)
        f.create_dataset("fill_i2_be", (2, 2), ">i2", fillvalue=-3)
        f.create_dataset("fill_scalar", (), "f4", fillvalue=1.25)
        f.create_dataset("written", data=np.ones(3, np.float32))
    ours = hdf5.File(path)
    assert not ours["zeros_f4"].allocated and ours["written"].allocated
    assert_same_file(str(path), path)
    np.testing.assert_array_equal(ours["fill_f8"][()], np.full(5, 2.5))
    ours["zeros_f4"].assign(np.arange(12, dtype=np.float32).reshape(3, 4))
    with ours as f:  # leaving the block keeps the assigned values (an importer's with)
        assert f["zeros_f4"][()][2, 3] == 11.0
    assert ours["zeros_f4"][()][2, 3] == 11.0
    with pytest.raises(ValueError, match="assigning"):
        ours["fill_f8"].assign(np.zeros(5, np.float32))


def test_compact_layout_and_user_block(tmp_path):
    path = tmp_path / "compact.h5"
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_userblock(512)
    fid = h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    with h5py.File(fid) as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        arr = np.arange(12, dtype=np.float64).reshape(3, 4)
        dsid = h5py.h5d.create(f.id, b"compact", h5py.h5t.py_create(arr.dtype),
                               h5py.h5s.create_simple(arr.shape), dcpl=dcpl)
        dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, arr)
        f.attrs["k"] = 1
    assert path.read_bytes()[:8] != hdf5.SIGNATURE  # the superblock sits past the user block
    assert hdf5.File(path)["compact"]._layout[1] == 0
    assert assert_same_file(str(path), path) == 1


def test_keras_file_equals_h5py(tmp_path):
    tf = pytest.importorskip("tensorflow")
    keras = tf.keras
    m = keras.Sequential([
        keras.layers.Input((6, 6, 3)),
        keras.layers.Conv2D(4, 3, padding="same"),
        keras.layers.BatchNormalization(),
        keras.layers.Flatten(),
        keras.layers.Dense(5, activation="softmax"),
    ])
    path = tmp_path / "m.h5"
    m.save(str(path))
    assert assert_same_file(str(path), path) == 8
    ours = hdf5.File(path)
    assert isinstance(ours.attrs["model_config"], str)
    assert ours["model_weights"].attrs["layer_names"].dtype == object


@pytest.mark.parametrize("case", ["chunked", "gzip", "latest", "bool", "null_attr"])
def test_unsupported_features_raise_named_errors(tmp_path, case):
    path = tmp_path / f"{case}.h5"
    kw = {"libver": "latest"} if case == "latest" else {}
    with h5py.File(path, "w", **kw) as f:
        g = f.create_group("g")
        if case == "chunked":
            g.create_dataset("d", data=np.zeros((4, 4), np.float32), chunks=(2, 2))
        elif case == "gzip":
            g.create_dataset("d", data=np.zeros((4, 4), np.float32), compression="gzip")
        elif case == "latest":
            g.create_dataset("d", data=np.zeros(3))
        elif case == "bool":
            g.create_dataset("d", data=np.array([True, False]))
        else:
            g.attrs["d"] = h5py.Empty("f4")
    feature = {"chunked": "chunked layout", "gzip": "filter pipeline",
               "latest": "superblock version", "bool": "enumerated",
               "null_attr": "null dataspace"}[case]
    with pytest.raises(UnsupportedHDF5Error, match=feature) as info:
        f = hdf5.File(path)
        f["g"].attrs if case == "null_attr" else f["g/d"]
    assert info.value.path == ("/" if case == "latest" else
                               "/g@d" if case == "null_attr" else "/g/d")


def test_not_an_hdf5_file(tmp_path):
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(b"\x00" * 2048)
    path = tmp_path / "x.bin"
    path.write_bytes(b"not hdf5" * 100)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(path)


def test_superblock_version_1_and_base_address(tmp_path):
    """A version-1 superblock (4 more bytes: the indexed-storage K and a
    reserved word) before the same objects, every address shifted by a
    base address of 4: written here from an h5py file by inserting the
    bytes, and read as h5py reads the original."""
    path = tmp_path / "v0.h5"
    with h5py.File(path, "w") as f:
        f.attrs["note"] = "superblock"
        g = f.create_group("g")
        g.create_dataset("d", data=np.arange(10, dtype=np.int32))
        g.attrs["names"] = np.array(["a", "bc"], dtype=object)
    raw = path.read_bytes()
    assert raw[8] == 0 and int.from_bytes(raw[24:32], "little") == 0
    v1 = bytearray(raw[:24] + (16).to_bytes(2, "little") + b"\0\0" + raw[24:])
    v1[8] = 1
    v1[28:36] = (4).to_bytes(8, "little")  # the base address: every address moves by 4
    assert assert_same_file(bytes(v1), path) == 1
