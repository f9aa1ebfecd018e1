"""Record readers — the DataVec ingestion tier.

A copy of ``deeplearning4j_tpu/data/records.py`` for the PyTorch port: host
numpy code, which the port keeps as the reference has it (the port imports
nothing of the JAX package).

Reference: org.datavec.api.records.reader.RecordReader and its zoo
(CSVRecordReader, LineRecordReader, CSVSequenceRecordReader,
ImageRecordReader — SURVEY.md §2.2 "DataVec API"/"DataVec image"). A record
is a list of field values (float or str — the reference's Writable
hierarchy collapses to plain Python values; NDArrayWritable is an ndarray).

Readers are restartable iterables; ``RecordReaderDataSetIterator`` bridges
records to the training tier's :class:`~deeplearning4j_tpu_torch.data.dataset.DataSet`
batches. Hot parse loops (CSV, netpbm decode, resize) go through the native
library (deeplearning4j_tpu_torch.native / libdl4jtpu) when built.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

from .. import native
from .dataset import DataSet

Writable = Union[float, int, str, np.ndarray]
Record = List[Writable]

DATA_WORKERS_ENV = "DL4J_TPU_DATA_WORKERS"


def resolve_data_workers(requested: Optional[int] = None) -> int:
    """Decode/augment worker-pool sizing. An explicit ``requested`` wins;
    otherwise the ``DL4J_TPU_DATA_WORKERS`` env var (the operator knob
    for the host input tier); otherwise 1. Always >= 1."""
    if requested is not None:
        return max(1, int(requested))
    env = os.environ.get(DATA_WORKERS_ENV)
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            raise ValueError(
                f"{DATA_WORKERS_ENV}={env!r} is not an integer") from None
    return 1


class RecordReader:
    """SPI: restartable stream of records."""

    def __iter__(self) -> Iterator[Record]:
        raise NotImplementedError

    def iter_records(self, skip: int = 0) -> Iterator[Record]:
        """One pass over the records, skipping the first ``skip`` — the
        mid-epoch resume entry point. The generic fallback produces and
        discards the skipped records (correct for any reader); readers
        with per-record cost (image decode) override with a free skip."""
        it = iter(self)
        for _ in range(skip):
            if next(it, None) is None:
                return
        yield from it

    def reset(self) -> None:
        """Default: readers here re-create their state in __iter__."""

    def labels(self) -> Optional[List[str]]:
        """Label vocabulary, for readers that define one (images)."""
        return None


class CollectionRecordReader(RecordReader):
    """Wraps an in-memory collection of records (reference:
    CollectionRecordReader)."""

    def __init__(self, records: Sequence[Record]) -> None:
        self._records = list(records)

    def __iter__(self) -> Iterator[Record]:
        return iter(self._records)


class LineRecordReader(RecordReader):
    """One record per line: ``[line]`` (reference: LineRecordReader)."""

    def __init__(self, path: str, encoding: str = "utf-8") -> None:
        self.path = path
        self.encoding = encoding

    def __iter__(self) -> Iterator[Record]:
        with open(self.path, "r", encoding=self.encoding) as f:
            for line in f:
                yield [line.rstrip("\n").rstrip("\r")]


def _convert_field(field: str) -> Writable:
    try:
        return float(field)
    except ValueError:
        return field


class CSVRecordReader(RecordReader):
    """Delimited text → records (reference: CSVRecordReader).

    With ``numeric=True`` the whole file is parsed by the native fast path
    into a float32 matrix (raising on non-numeric data); otherwise each
    field falls back from float to str individually.
    """

    def __init__(self, path: str, *, delimiter: str = ",",
                 skip_lines: int = 0, numeric: bool = False,
                 encoding: str = "utf-8") -> None:
        self.path = path
        self.delimiter = delimiter
        self.skip_lines = int(skip_lines)
        self.numeric = bool(numeric)
        self.encoding = encoding

    def __iter__(self) -> Iterator[Record]:
        if self.numeric:
            with open(self.path, "rb") as f:
                matrix = native.parse_csv(f.read(), self.delimiter,
                                          self.skip_lines)
            for row in matrix:
                yield [float(v) for v in row]
            return
        with open(self.path, "r", encoding=self.encoding) as f:
            skipped = 0
            for line in f:
                line = line.rstrip("\n").rstrip("\r")
                if not line.strip():
                    continue
                if skipped < self.skip_lines:
                    skipped += 1
                    continue
                yield [_convert_field(x) for x in line.split(self.delimiter)]


class CSVSequenceRecordReader(RecordReader):
    """Sequence reader: one CSV file per sequence (reference:
    CSVSequenceRecordReader). Each record is a [timesteps, fields] list of
    per-step field lists."""

    def __init__(self, paths: Sequence[str], *, delimiter: str = ",",
                 skip_lines: int = 0, encoding: str = "utf-8") -> None:
        self.paths = list(paths)
        self.delimiter = delimiter
        self.skip_lines = int(skip_lines)
        self.encoding = encoding

    def __iter__(self) -> Iterator[List[Record]]:
        for p in self.paths:
            reader = CSVRecordReader(p, delimiter=self.delimiter,
                                     skip_lines=self.skip_lines,
                                     encoding=self.encoding)
            yield list(reader)


def _pil():
    try:
        from PIL import Image

        return Image
    except ImportError:  # pragma: no cover - env-dependent
        return None


class ImageRecordReader(RecordReader):
    """Image directory reader (reference: ImageRecordReader +
    NativeImageLoader — SURVEY.md §2.2 'the ImageNet input path').

    Walks ``root`` for images, decodes + bilinearly resizes to
    [height, width, channels], and when ``label_from_path`` appends the
    parent-directory label index. Record: ``[ndarray(h, w, c), label_idx]``.

    Decode story: netpbm (P5/P6) through the native C++ codec always;
    PNG/JPEG/BMP/GIF through Pillow when it is importable (it is in this
    environment). ``transform`` applies an
    :class:`~..data.image_transform.ImageTransform` (augmentation pipeline)
    to every decoded image, the reference's ImageRecordReader(transform)
    seam.
    """

    NETPBM_EXTENSIONS = (".ppm", ".pgm", ".pnm")
    PIL_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")

    def __init__(self, height: int, width: int, channels: int = 3, *,
                 root: Optional[str] = None,
                 paths: Optional[Sequence[str]] = None,
                 label_from_path: bool = True,
                 transform=None, seed: int = 0,
                 output_dtype: str = "float32",
                 workers: Optional[int] = None,
                 shuffle: bool = False) -> None:
        """``output_dtype="uint8"`` is the TPU-native fast path: pixels stay
        uint8 on host end to end (decode header parse + crop/flip as numpy
        VIEWS, one small contiguous copy), transfer to HBM at 1 byte/px,
        and the cast to the model's float dtype happens ON DEVICE inside
        the jitted step (core.dtypes.as_input) — the host float conversion
        + [0,1] scaling that dominates the float32 path (~300us/img of its
        ~400us on this host) disappears. Values are raw 0..255; fold the
        1/255 into the model (or BN absorbs it). Only geometric transforms
        (flip/crop) are uint8-safe; value-space transforms raise.

        ``workers > 1`` decodes+augments on a thread pool (the netpbm/PIL
        decode and the resize release the GIL), preserving record order —
        the reference's multi-threaded NativeImageLoader ingestion. The
        default (``workers=None``) resolves through the
        ``DL4J_TPU_DATA_WORKERS`` env var (:func:`resolve_data_workers`),
        so deployments size the host decode tier without code changes;
        record order is identical for every worker count.

        ``shuffle=True`` permutes the path list ONCE at construction with
        ``seed`` — a deterministic epoch order that is independent of
        both ``workers`` and any prefetch depth stacked on top."""
        if (root is None) == (paths is None):
            raise ValueError("provide exactly one of root= or paths=")
        if output_dtype not in ("float32", "uint8"):
            raise ValueError("output_dtype must be float32 or uint8")
        self.height, self.width, self.channels = height, width, channels
        self.label_from_path = label_from_path
        self.transform = transform
        self.output_dtype = output_dtype
        self.workers = resolve_data_workers(workers)
        self._seed = int(seed)
        self._rng = np.random.RandomState(seed)
        self._epochs_started = 0  # passes begun — the rng-stream position
        # resolved once: PIL availability can't change mid-scan, and the
        # walk below tests this per file at ImageNet scale
        self.EXTENSIONS = self.NETPBM_EXTENSIONS + (
            self.PIL_EXTENSIONS if _pil() is not None else ())
        if root is not None:
            found: List[str] = []
            for dirpath, _dirnames, filenames in sorted(os.walk(root)):
                for fn in sorted(filenames):
                    if fn.lower().endswith(self.EXTENSIONS):
                        found.append(os.path.join(dirpath, fn))
            self.paths = found
        else:
            self.paths = list(paths)  # type: ignore[arg-type]
        if shuffle:
            order = np.random.default_rng(seed).permutation(len(self.paths))
            self.paths = [self.paths[i] for i in order]
        self._labels = sorted({os.path.basename(os.path.dirname(p))
                               for p in self.paths}) if label_from_path else []
        label_idx = {n: i for i, n in enumerate(self._labels)}
        # per-path label resolved once — the iter loop is the ImageNet-scale
        # hot path, no per-image string scans there
        self._path_labels = [label_idx[os.path.basename(os.path.dirname(p))]
                             for p in self.paths] if label_from_path else []

    def labels(self) -> Optional[List[str]]:
        return self._labels or None

    def _decode(self, path: str) -> np.ndarray:
        if path.lower().endswith(self.NETPBM_EXTENSIONS):
            with open(path, "rb") as f:
                return native.decode_netpbm(f.read())
        Image = _pil()
        if Image is None:
            raise ValueError(
                f"{path}: only netpbm is decodable without Pillow "
                "(convert with e.g. `mogrify -format ppm`)")
        with Image.open(path) as im:
            if im.mode not in ("RGB", "L"):
                im = im.convert("RGB" if self.channels == 3 else "L")
            arr = np.asarray(im, dtype=np.float32) / 255.0  # match netpbm [0,1]
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr

    def _decode_u8(self, path: str) -> np.ndarray:
        """Decode to uint8 HWC with ZERO per-pixel host math: netpbm is a
        header parse + frombuffer view; PIL hands back uint8 natively."""
        if path.lower().endswith(self.NETPBM_EXTENSIONS):
            with open(path, "rb") as f:
                buf = f.read()
            # shared front-anchored header parse (native.py) — same
            # semantics as the float decoder: '#' comments, exactly one
            # whitespace byte before the raster; back-anchored slicing
            # would silently shift pixels on trailing-byte files
            if buf[:2] not in (b"P5", b"P6"):
                raise ValueError(f"{path}: not a binary netpbm (P5/P6)")
            try:
                w, h, c, maxval, pos = native.parse_netpbm_header(buf)
            except ValueError as e:
                raise ValueError(f"{path}: malformed netpbm header") from e
            if maxval > 255:
                raise ValueError(
                    f"{path}: 16-bit netpbm (maxval {maxval}) unsupported "
                    "on the uint8 fast path")
            data = buf[pos: pos + h * w * c]
            if len(data) != h * w * c:
                raise ValueError(f"{path}: truncated netpbm raster")
            arr = np.frombuffer(data, np.uint8).reshape(h, w, c)
            if maxval != 255:
                # rounded rescale to the full byte range so the uint8 fast
                # path matches the float decoder within rounding (floor
                # division diverged by up to 1 LSB)
                arr = ((arr.astype(np.uint16) * 255 + maxval // 2)
                       // maxval).astype(np.uint8)
            return arr
        Image = _pil()
        if Image is None:
            raise ValueError(f"{path}: only netpbm decodable without Pillow")
        with Image.open(path) as im:
            if im.mode not in ("RGB", "L"):
                im = im.convert("RGB" if self.channels == 3 else "L")
            arr = np.asarray(im)  # uint8
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr

    def _load(self, path: str, rng=None) -> np.ndarray:
        rng = rng if rng is not None else self._rng
        if self.output_dtype == "uint8":
            img = self._decode_u8(path)
            if self.transform is not None:
                if not getattr(self.transform, "uint8_safe", False):
                    raise ValueError(
                        "output_dtype='uint8' supports only geometric "
                        "(uint8_safe) transforms — flip/crop; value-space "
                        "transforms need the float32 path")
                img = np.asarray(self.transform.call(img, rng))
            if img.shape[:2] != (self.height, self.width):
                # resize needs float math; round (not truncate) back so the
                # uint8 output matches the float path within rounding
                img = np.rint(np.clip(native.resize_bilinear(
                    img.astype(np.float32), self.height, self.width),
                    0, 255)).astype(np.uint8)
        else:
            img = self._decode(path)
            if self.transform is not None:
                img = np.asarray(self.transform.call(
                    np.asarray(img, np.float32), rng))
            if img.shape[:2] != (self.height, self.width):
                img = native.resize_bilinear(img, self.height, self.width)
        if img.shape[2] != self.channels:
            if self.channels == 3 and img.shape[2] == 1:
                img = np.repeat(img, 3, axis=2)
            elif self.channels == 1 and img.shape[2] == 3:
                img = img.mean(axis=2, keepdims=True)
                if self.output_dtype == "uint8":
                    img = np.rint(img).astype(np.uint8)
            else:
                raise ValueError(
                    f"cannot adapt {img.shape[2]} channels to "
                    f"{self.channels}: {path}")
        return np.ascontiguousarray(img)

    def __iter__(self) -> Iterator[Record]:
        return self.iter_records(0)

    def iter_records(self, skip: int = 0) -> Iterator[Record]:
        # per-image independent rngs (same derivation for every worker
        # count — the loader-determinism contract, see
        # tests/test_sharded_loader.py) make the skip FREE: the full seed
        # vector is drawn so the pass's rng stream stays identical, but
        # skipped images are never decoded.
        seeds = self._rng.randint(0, 2**31 - 1, size=len(self.paths))
        self._epochs_started += 1
        if self.workers > 1:
            yield from self._iter_parallel(seeds, skip)
            return
        for i in range(skip, len(self.paths)):
            rec: Record = [self._load(
                self.paths[i], rng=np.random.RandomState(seeds[i]))]
            if self.label_from_path:
                rec.append(self._path_labels[i])
            yield rec

    def state_dict(self) -> dict:
        """Reader-level resume state: how many passes have STARTED. Each
        pass draws one per-image seed vector from the reader's stateful
        rng, so the pass index pins the augmentation stream; the record
        cursor within the pass belongs to the dataset iterator above."""
        return {"epoch": self._epochs_started}

    def load_state_dict(self, state: dict) -> None:
        """Repositions the rng stream so the next :meth:`iter_records`
        call RE-ENTERS the snapshotted pass — it draws the exact seed
        vector that pass drew, and the caller skips to its cursor."""
        epoch = max(0, int(state.get("epoch", 0)) - 1)
        self._rng = np.random.RandomState(self._seed)
        for _ in range(epoch):  # replay the completed passes' seed draws
            self._rng.randint(0, 2**31 - 1, size=len(self.paths))
        self._epochs_started = epoch

    def _iter_parallel(self, seeds, skip: int = 0) -> Iterator[Record]:
        """Thread-pool decode+augment, order-preserving, bounded in-flight
        window (the reference's multi-threaded image ingestion; decode and
        resize release the GIL, so workers scale with real cores)."""
        from concurrent.futures import ThreadPoolExecutor

        def load(i: int):
            return self._load(self.paths[i],
                              rng=np.random.RandomState(seeds[i]))

        window = 4 * self.workers
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = {}
            nxt = skip
            for i in range(skip, len(self.paths)):
                pending[i] = pool.submit(load, i)
                while len(pending) >= window or (
                        nxt in pending and pending[nxt].done()):
                    rec: Record = [pending.pop(nxt).result()]
                    if self.label_from_path:
                        rec.append(self._path_labels[nxt])
                    yield rec
                    nxt += 1
            while nxt in pending:
                rec = [pending.pop(nxt).result()]
                if self.label_from_path:
                    rec.append(self._path_labels[nxt])
                yield rec
                nxt += 1


class RecordReaderDataSetIterator:
    """Records → DataSet batches (reference:
    org.deeplearning4j.datasets.datavec.RecordReaderDataSetIterator).

    ``label_index`` selects the label field (negative indexes allowed);
    classification one-hots it to ``num_classes``, regression keeps the
    raw value(s). ndarray features (image readers) are stacked as-is.
    """

    def __init__(self, reader: RecordReader, batch_size: int, *,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False) -> None:
        self.reader = reader
        self._batch = int(batch_size)
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        if not regression and num_classes is None:
            raise ValueError("classification needs num_classes")

    # -- DataSetIterator protocol (lookahead over the generator) so this
    # composes with AsyncDataSetIterator / MappedDataSetIterator ----------
    _gen = None
    _lookahead = None
    _epochs_started = 0
    _batches_out = 0

    def batch_size(self) -> int:
        return self._batch

    def _start_generation(self, skip_batches: int = 0):
        self._epochs_started += 1
        self._batches_out = skip_batches
        return self._generate(skip_records=skip_batches * self._batch)

    def has_next(self) -> bool:
        if self._gen is None:
            self._gen = self._start_generation()
        if self._lookahead is None:
            self._lookahead = next(self._gen, None)
        return self._lookahead is not None

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        item, self._lookahead = self._lookahead, None
        self._batches_out += 1
        return item

    def reset(self) -> None:
        self.reader.reset()
        self._gen = None
        self._lookahead = None
        self._batches_out = 0

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self._start_generation()

    def state_dict(self) -> dict:
        # the lookahead batch was pulled from the generator but never
        # handed out — _batches_out only counts next() returns, so it is
        # correctly re-produced on resume
        return {"epoch": self._epochs_started, "batches": self._batches_out}

    def load_state_dict(self, state: dict) -> None:
        epoch = int(state["epoch"])
        batches = int(state["batches"])
        loader = getattr(self.reader, "load_state_dict", None)
        if callable(loader):
            self.reader.load_state_dict({"epoch": epoch})
        else:
            self.reader.reset()
        self._epochs_started = max(0, epoch - 1)
        self._lookahead = None
        if epoch > 0:
            self._gen = self._start_generation(skip_batches=batches)
        else:
            self._gen = None
            self._batches_out = 0

    def _generate(self, skip_records: int = 0) -> Iterator[DataSet]:
        feats: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        for rec in self.reader.iter_records(skip_records):
            li = self.label_index if self.label_index >= 0 \
                else len(rec) + self.label_index
            label_val = rec[li]
            fields = [v for i, v in enumerate(rec) if i != li]
            if len(fields) == 1 and isinstance(fields[0], np.ndarray):
                # keep the reader's dtype: uint8 readers ship raw bytes to
                # the device, where as_input does the float cast
                feats.append(fields[0])
            else:
                feats.append(np.asarray([float(v) for v in fields],
                                        np.float32))
            if self.regression:
                labels.append(np.asarray([float(label_val)], np.float32))
            else:
                cls = int(label_val)
                if not 0 <= cls < self.num_classes:
                    # explicit: numpy would silently wrap negative labels
                    raise ValueError(
                        f"label {cls} outside [0, {self.num_classes})")
                onehot = np.zeros(self.num_classes, np.float32)
                onehot[cls] = 1.0
                labels.append(onehot)
            if len(feats) == self._batch:
                yield DataSet(np.stack(feats), np.stack(labels))
                feats, labels = [], []
        if feats:
            yield DataSet(np.stack(feats), np.stack(labels))
