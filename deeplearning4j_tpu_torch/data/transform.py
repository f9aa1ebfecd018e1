"""Schema + TransformProcess — DataVec's declarative ETL.

A copy of ``deeplearning4j_tpu/data/transform.py`` for the PyTorch port: host
numpy code, which the port keeps as the reference has it (the port imports
nothing of the JAX package).

Reference: org.datavec.api.transform.{schema.Schema, TransformProcess}
(SURVEY.md §2.2 "DataVec API"): a typed column schema and an ordered,
serializable list of column transforms executed over records. The
serializable-pipeline property is preserved — a TransformProcess
round-trips through JSON (to_json/from_json), like every config object in
this framework (config-is-data, SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

from .records import Record, RecordReader


class ColumnType(enum.Enum):
    DOUBLE = "double"
    INTEGER = "integer"
    STRING = "string"
    CATEGORICAL = "categorical"


@dataclasses.dataclass(frozen=True)
class ColumnMeta:
    name: str
    type: ColumnType
    categories: tuple = ()  # for CATEGORICAL


class Schema:
    """Typed column schema (reference: org.datavec.api.transform.schema.Schema)."""

    def __init__(self, columns: Sequence[ColumnMeta]) -> None:
        self.columns = list(columns)
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")

    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(f"no column {name!r}; have {self.names()}")

    def column(self, name: str) -> ColumnMeta:
        return self.columns[self.index_of(name)]

    @staticmethod
    def builder() -> "SchemaBuilder":
        return SchemaBuilder()

    def to_dict(self) -> Dict[str, Any]:
        return {"columns": [
            {"name": c.name, "type": c.type.value,
             "categories": list(c.categories)} for c in self.columns]}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Schema":
        return Schema([ColumnMeta(c["name"], ColumnType(c["type"]),
                                  tuple(c.get("categories", ())))
                       for c in d["columns"]])


class SchemaBuilder:
    def __init__(self) -> None:
        self._cols: List[ColumnMeta] = []

    def add_double_column(self, name: str) -> "SchemaBuilder":
        self._cols.append(ColumnMeta(name, ColumnType.DOUBLE))
        return self

    def add_integer_column(self, name: str) -> "SchemaBuilder":
        self._cols.append(ColumnMeta(name, ColumnType.INTEGER))
        return self

    def add_string_column(self, name: str) -> "SchemaBuilder":
        self._cols.append(ColumnMeta(name, ColumnType.STRING))
        return self

    def add_categorical_column(self, name: str,
                               categories: Sequence[str]) -> "SchemaBuilder":
        self._cols.append(ColumnMeta(name, ColumnType.CATEGORICAL,
                                     tuple(categories)))
        return self

    def build(self) -> Schema:
        return Schema(self._cols)


# ---------------------------------------------------------------------------
# Transform ops. Each op: apply(records, schema) -> (records, new_schema),
# and a dict round-trip for serialization.
# ---------------------------------------------------------------------------

_OP_REGISTRY: Dict[str, type] = {}


def _register(cls):
    _OP_REGISTRY[cls.kind] = cls
    return cls


class TransformOp:
    kind = "base"

    def apply(self, records, schema):
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["kind"] = self.kind
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        d = dict(d)
        d.pop("kind")
        return cls(**d)


@_register
class RemoveColumns(TransformOp):
    kind = "remove_columns"

    def __init__(self, names: Sequence[str]) -> None:
        self.names = list(names)

    def apply(self, records, schema):
        idxs = sorted(schema.index_of(n) for n in self.names)
        keep = [i for i in range(len(schema.columns)) if i not in idxs]
        new_schema = Schema([schema.columns[i] for i in keep])
        return [[r[i] for i in keep] for r in records], new_schema


@_register
class RenameColumn(TransformOp):
    kind = "rename_column"

    def __init__(self, old: str, new: str) -> None:
        self.old, self.new = old, new

    def apply(self, records, schema):
        i = schema.index_of(self.old)
        cols = list(schema.columns)
        cols[i] = dataclasses.replace(cols[i], name=self.new)
        return records, Schema(cols)


@_register
class CategoricalToOneHot(TransformOp):
    kind = "categorical_to_one_hot"

    def __init__(self, name: str) -> None:
        self.name = name

    def apply(self, records, schema):
        i = schema.index_of(self.name)
        col = schema.columns[i]
        if col.type is not ColumnType.CATEGORICAL:
            raise ValueError(f"{self.name} is {col.type}, not categorical")
        cats = list(col.categories)
        cols = list(schema.columns)
        cols[i:i + 1] = [ColumnMeta(f"{self.name}[{c}]", ColumnType.DOUBLE)
                         for c in cats]
        out = []
        for r in records:
            v = r[i]
            if v not in cats:
                raise ValueError(f"unknown category {v!r} for {self.name}")
            onehot = [1.0 if c == v else 0.0 for c in cats]
            out.append(list(r[:i]) + onehot + list(r[i + 1:]))
        return out, Schema(cols)


@_register
class StringToCategorical(TransformOp):
    kind = "string_to_categorical"

    def __init__(self, name: str, categories: Sequence[str]) -> None:
        self.name = name
        self.categories = list(categories)

    def apply(self, records, schema):
        i = schema.index_of(self.name)
        cols = list(schema.columns)
        cols[i] = ColumnMeta(self.name, ColumnType.CATEGORICAL,
                             tuple(self.categories))
        return records, Schema(cols)


@_register
class CategoricalToInteger(TransformOp):
    kind = "categorical_to_integer"

    def __init__(self, name: str) -> None:
        self.name = name

    def apply(self, records, schema):
        i = schema.index_of(self.name)
        col = schema.columns[i]
        if col.type is not ColumnType.CATEGORICAL:
            raise ValueError(f"{self.name} is {col.type}, not categorical")
        cats = list(col.categories)
        cols = list(schema.columns)
        cols[i] = ColumnMeta(self.name, ColumnType.INTEGER)
        out = []
        for r in records:
            out.append(list(r[:i]) + [cats.index(r[i])] + list(r[i + 1:]))
        return out, Schema(cols)


_MATH_OPS: Dict[str, Callable[[float, float], float]] = {
    "add": lambda a, b: a + b,
    "subtract": lambda a, b: a - b,
    "multiply": lambda a, b: a * b,
    "divide": lambda a, b: a / b,
}


@_register
class DoubleMathOp(TransformOp):
    kind = "double_math_op"

    def __init__(self, name: str, op: str, value: float) -> None:
        if op not in _MATH_OPS:
            raise ValueError(f"unknown math op {op!r}")
        self.name, self.op, self.value = name, op, float(value)

    def apply(self, records, schema):
        i = schema.index_of(self.name)
        fn = _MATH_OPS[self.op]
        out = [list(r[:i]) + [fn(float(r[i]), self.value)] + list(r[i + 1:])
               for r in records]
        return out, schema


@_register
class MinMaxNormalize(TransformOp):
    kind = "min_max_normalize"

    def __init__(self, name: str, min_value: float, max_value: float) -> None:
        self.name = name
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def apply(self, records, schema):
        i = schema.index_of(self.name)
        span = self.max_value - self.min_value
        if span == 0:
            raise ValueError("max_value == min_value")
        out = [list(r[:i]) + [(float(r[i]) - self.min_value) / span]
               + list(r[i + 1:]) for r in records]
        return out, schema


@_register
class FilterInvalid(TransformOp):
    """Drop rows whose named double column is NaN/inf."""

    kind = "filter_invalid"

    def __init__(self, name: str) -> None:
        self.name = name

    def apply(self, records, schema):
        i = schema.index_of(self.name)
        return [r for r in records if math.isfinite(float(r[i]))], schema


@_register
class ConditionalFilter(TransformOp):
    """Drop rows where column <op> value is true (op: lt/gt/eq/ne)."""

    kind = "conditional_filter"
    _CONDS = {"lt": lambda a, b: a < b, "gt": lambda a, b: a > b,
              "eq": lambda a, b: a == b, "ne": lambda a, b: a != b}

    def __init__(self, name: str, op: str, value: float) -> None:
        if op not in self._CONDS:
            raise ValueError(f"unknown condition {op!r}")
        self.name, self.op, self.value = name, op, value

    def apply(self, records, schema):
        i = schema.index_of(self.name)
        cond = self._CONDS[self.op]
        return [r for r in records
                if not cond(float(r[i]), self.value)], schema


class TransformProcess:
    """Ordered, serializable transform pipeline (reference:
    org.datavec.api.transform.TransformProcess)."""

    def __init__(self, initial_schema: Schema,
                 ops: Sequence[TransformOp]) -> None:
        self.initial_schema = initial_schema
        self.ops = list(ops)
        # schema before each op, resolved once — execute() (and the
        # streaming per-record reader) must not rebuild/revalidate the
        # schema chain per call
        self._schemas: List[Schema] = []
        schema = initial_schema
        for op in self.ops:
            self._schemas.append(schema)
            _, schema = op.apply([], schema)
        self._final = schema

    @staticmethod
    def builder(schema: Schema) -> "TransformProcessBuilder":
        return TransformProcessBuilder(schema)

    def final_schema(self) -> Schema:
        return self._final

    def execute(self, records: Sequence[Record]) -> List[Record]:
        out = [list(r) for r in records]
        for op, schema in zip(self.ops, self._schemas):
            out, _ = op.apply(out, schema)
        return out

    def to_json(self) -> str:
        return json.dumps({
            "initial_schema": self.initial_schema.to_dict(),
            "ops": [op.to_dict() for op in self.ops],
        })

    @staticmethod
    def from_json(s: str) -> "TransformProcess":
        d = json.loads(s)
        ops = [_OP_REGISTRY[o["kind"]].from_dict(o) for o in d["ops"]]
        return TransformProcess(Schema.from_dict(d["initial_schema"]), ops)


class TransformProcessBuilder:
    def __init__(self, schema: Schema) -> None:
        self._schema = schema
        self._ops: List[TransformOp] = []

    def _add(self, op: TransformOp) -> "TransformProcessBuilder":
        self._ops.append(op)
        return self

    def remove_columns(self, *names: str):
        return self._add(RemoveColumns(names))

    def rename_column(self, old: str, new: str):
        return self._add(RenameColumn(old, new))

    def categorical_to_one_hot(self, name: str):
        return self._add(CategoricalToOneHot(name))

    def categorical_to_integer(self, name: str):
        return self._add(CategoricalToInteger(name))

    def string_to_categorical(self, name: str, categories: Sequence[str]):
        return self._add(StringToCategorical(name, categories))

    def double_math_op(self, name: str, op: str, value: float):
        return self._add(DoubleMathOp(name, op, value))

    def min_max_normalize(self, name: str, min_value: float,
                          max_value: float):
        return self._add(MinMaxNormalize(name, min_value, max_value))

    def filter_invalid(self, name: str):
        return self._add(FilterInvalid(name))

    def conditional_filter(self, name: str, op: str, value: float):
        return self._add(ConditionalFilter(name, op, value))

    def build(self) -> TransformProcess:
        # validate the chain against the schema now (fail at build, not run)
        tp = TransformProcess(self._schema, self._ops)
        tp.final_schema()
        return tp


class TransformProcessRecordReader(RecordReader):
    """Reader decorator applying a TransformProcess on the fly (reference:
    TransformProcessRecordReader). A real :class:`RecordReader` so the
    base ``iter_records(skip=)`` resume path applies — the skip counts
    POST-transform records, which is the consumer-visible cursor even
    when filters drop rows."""

    def __init__(self, reader, process: TransformProcess) -> None:
        self.reader = reader
        self.process = process

    def __iter__(self):
        for rec in self.reader:
            out = self.process.execute([rec])
            if out:  # filters may drop the row
                yield out[0]

    def reset(self) -> None:
        self.reader.reset()

    def labels(self):
        return self.reader.labels()
