"""The port's DataVec tier against the JAX package: record readers (CSV, CSV
sequence, line, collection, image with the float32 and uint8 outputs and
parallel workers), ``RecordReaderDataSetIterator``, ``Schema`` and
``TransformProcess`` with its JSON round trip (across the packages too),
``TransformProcessRecordReader`` and the procedural fetchers. Each case
reads the same files or records through both packages and asks for equal
results (the code is the same numpy, so equal means bit-equal)."""

import numpy as np
import pytest

from deeplearning4j_tpu.data import fetchers as jfetch
from deeplearning4j_tpu.data import image_transform as jimg
from deeplearning4j_tpu.data import records as jrec
from deeplearning4j_tpu.data import transform as jtf

from deeplearning4j_tpu_torch.data import fetchers as pfetch
from deeplearning4j_tpu_torch.data import image_transform as pimg
from deeplearning4j_tpu_torch.data import records as prec
from deeplearning4j_tpu_torch.data import transform as ptf

from torch_native_helpers import shared_native_library  # noqa: F401  (autouse)

RECORDS = {"jax": jrec, "port": prec}


@pytest.fixture
def csv_file(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("f1,f2,label\n1.0,2.0,0\n3.0,4.0,1\n5.0,6.0,2\n7.0,8.0,0\n")
    return str(p)


def _both(fn):
    """fn(records module) for each package; asserts the results are equal."""
    j, p = fn(jrec), fn(prec)
    _assert_same(j, p)
    return p


def _assert_same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif hasattr(a, "features"):
        for x, y in zip((a.features, a.labels, a.features_mask, a.labels_mask),
                        (b.features, b.labels, b.features_mask, b.labels_mask)):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("kw", [dict(skip_lines=1), dict(), dict(skip_lines=1, numeric=True)],
                         ids=["skip", "header", "numeric"])
def test_csv_record_reader(csv_file, kw):
    recs = _both(lambda r: list(r.CSVRecordReader(csv_file, **kw)))
    assert len(recs) == 4 + ("skip_lines" not in kw)


def test_line_collection_and_sequence_readers(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("hello\nworld\n")
    assert _both(lambda r: list(r.LineRecordReader(str(p)))) == [["hello"], ["world"]]
    _both(lambda r: [list(c) for c in [r.CollectionRecordReader([[1, 2], [3, 4]])] * 2])
    for i, content in enumerate(["1,2\n3,4\n", "5,6\n"]):
        (tmp_path / f"seq{i}.csv").write_text(content)
    paths = [str(tmp_path / "seq0.csv"), str(tmp_path / "seq1.csv")]
    assert _both(lambda r: list(r.CSVSequenceRecordReader(paths))) == \
        [[[1.0, 2.0], [3.0, 4.0]], [[5.0, 6.0]]]


def _image_tree(tmp_path, n=6, h=10, w=12):
    rs = np.random.RandomState(0)
    for i in range(n):
        d = tmp_path / ("cat", "dog")[i % 2]
        d.mkdir(exist_ok=True)
        body = rs.randint(0, 256, (h, w, 3), np.uint8).tobytes()
        (d / f"{i}.ppm").write_bytes(b"P6\n%d %d\n255\n" % (w, h) + body)
    return str(tmp_path)


@pytest.mark.parametrize("output_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("workers", [1, 2])
def test_image_reader_and_iterator(tmp_path, output_dtype, workers):
    root = _image_tree(tmp_path)

    def run(r):
        img = jimg if r is jrec else pimg
        reader = r.ImageRecordReader(8, 8, 3, root=root, output_dtype=output_dtype,
                                     workers=workers, shuffle=True, seed=5,
                                     transform=img.FlipImageTransform(mode=None))
        it = r.RecordReaderDataSetIterator(reader, 4, label_index=1, num_classes=2)
        return reader.labels(), [ds for ds in it]

    labels, batches = _both(run)
    assert labels == ["cat", "dog"] and [b.num_examples() for b in batches] == [4, 2]
    assert batches[0].features.dtype == np.dtype(output_dtype)


def test_record_iterator_regression_and_label_checks(csv_file):
    def run(r):
        it = r.RecordReaderDataSetIterator(r.CSVRecordReader(csv_file, skip_lines=1),
                                           batch_size=4, label_index=0, regression=True)
        cls = r.RecordReaderDataSetIterator(r.CSVRecordReader(csv_file, skip_lines=1),
                                            batch_size=3, label_index=-1, num_classes=3)
        return list(it) + list(cls)

    _both(run)
    for r in RECORDS.values():
        bad = r.RecordReaderDataSetIterator(r.CollectionRecordReader([[1.0, -1]]),
                                            batch_size=1, num_classes=3)
        with pytest.raises(ValueError, match="label -1"):
            list(bad)


def test_resolve_data_workers_matches_jax(monkeypatch):
    for env in (None, "3", "0"):
        if env is None:
            monkeypatch.delenv(prec.DATA_WORKERS_ENV, raising=False)
        else:
            monkeypatch.setenv(prec.DATA_WORKERS_ENV, env)
        for arg in (None, 1, 4):
            assert prec.resolve_data_workers(arg) == jrec.resolve_data_workers(arg)


def _tp(tf):
    schema = (tf.Schema.builder()
              .add_double_column("x")
              .add_categorical_column("color", ["red", "green"])
              .add_string_column("junk")
              .add_integer_column("n")
              .build())
    return (tf.TransformProcess.builder(schema)
            .remove_columns("junk")
            .double_math_op("x", "multiply", 2.0)
            .min_max_normalize("x", 0.0, 10.0)
            .categorical_to_one_hot("color")
            .conditional_filter("n", "gt", 100.0)
            .build())


def test_transform_process_and_json_round_trip_across_packages():
    recs = [[1.0, "red", "a", 3], [5.0, "green", "b", 200], [2.5, "green", "c", 7]]
    jtp, ptp = _tp(jtf), _tp(ptf)
    assert ptp.final_schema().names() == jtp.final_schema().names()
    want = jtp.execute(recs)
    assert ptp.execute(recs) == want
    assert ptp.to_json() == jtp.to_json()
    # a process written by one package runs in the other
    assert ptf.TransformProcess.from_json(jtp.to_json()).execute(recs) == want
    assert jtf.TransformProcess.from_json(ptp.to_json()).execute(recs) == want
    schema = ptf.Schema.builder().add_double_column("x").build()
    tp = ptf.TransformProcess.builder(schema).filter_invalid("x").build()
    assert tp.execute([[1.0], [float("nan")], [2.0]]) == [[1.0], [2.0]]
    with pytest.raises(KeyError):
        ptf.TransformProcess.builder(schema).remove_columns("nope").build()


def test_transform_process_record_reader(csv_file):
    def run(r):
        tf = jtf if r is jrec else ptf
        schema = (tf.Schema.builder().add_double_column("f1")
                  .add_double_column("f2").add_integer_column("label").build())
        tp = (tf.TransformProcess.builder(schema)
              .min_max_normalize("f1", 0.0, 8.0).min_max_normalize("f2", 0.0, 8.0).build())
        reader = tf.TransformProcessRecordReader(r.CSVRecordReader(csv_file, skip_lines=1), tp)
        return list(r.RecordReaderDataSetIterator(reader, batch_size=3, num_classes=3))

    assert len(_both(run)) == 2


@pytest.mark.parametrize("name,args", [
    ("Cifar10DataSetIterator", (8,)), ("SvhnDataSetIterator", (8,)),
    ("TinyImageNetDataSetIterator", (4,)), ("EmnistDataSetIterator", ("balanced", 8)),
    ("EmnistDataSetIterator", ("digits", 8))])
@pytest.mark.parametrize("train", [True, False])
def test_fetchers_match_jax(name, args, train):
    kw = dict(train=train, num_examples=16, seed=4)
    j, p = getattr(jfetch, name)(*args, **kw), getattr(pfetch, name)(*args, **kw)
    assert p.provenance == j.provenance
    jb, pb = list(j), list(p)
    assert len(pb) == len(jb) > 0
    for a, b in zip(jb, pb):
        assert a.features.dtype == b.features.dtype
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
