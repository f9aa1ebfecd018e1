"""Config-DSL infrastructure (port of ``deeplearning4j_tpu/core/config.py``).

Configs are immutable dataclasses registered under their class name so that
polymorphic fields (layers, updaters, losses...) round-trip through JSON with
an ``@class`` discriminator. The JSON is the JAX package's: a config written
by either package decodes in the other.

Enums are written as ``deeplearning4j_tpu.<module>:<Enum>``. The decoder here
maps that prefix to ``deeplearning4j_tpu_torch.`` and imports the port's
module, never the JAX one; the encoder writes the JAX prefix back, so the
files stay interchangeable. An ``@class`` name this package has not ported
raises ``KeyError`` naming it.

Nothing here touches torch; configs are pure data.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import json
from typing import Any, Dict, Type, TypeVar

_CONFIG_REGISTRY: Dict[str, type] = {}

T = TypeVar("T")

_TYPE_KEY = "@class"
_PORT_PACKAGE = "deeplearning4j_tpu_torch"
_JSON_PACKAGE = "deeplearning4j_tpu"  # the module prefix the JSON carries


def register_config(cls: Type[T]) -> Type[T]:
    """Class decorator: register a dataclass for polymorphic JSON round-trip."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"@register_config requires a dataclass, got {cls}")
    name = cls.__name__
    existing = _CONFIG_REGISTRY.get(name)
    if existing is not None and existing is not cls:
        raise ValueError(f"Config name collision: {name}")
    _CONFIG_REGISTRY[name] = cls
    return cls


def config_class(name: str) -> type:
    try:
        return _CONFIG_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown config class {name!r}: not ported to "
            f"{_PORT_PACKAGE} (known: {sorted(_CONFIG_REGISTRY)})"
        ) from None


def _json_module(module: str) -> str:
    """Port module path -> the module path written into config JSON."""
    if module == _PORT_PACKAGE or module.startswith(_PORT_PACKAGE + "."):
        return _JSON_PACKAGE + module[len(_PORT_PACKAGE):]
    return module


def _port_module(module: str) -> str:
    """Module path read from config JSON -> the port's module path."""
    if module == _JSON_PACKAGE or module.startswith(_JSON_PACKAGE + "."):
        return _PORT_PACKAGE + module[len(_JSON_PACKAGE):]
    return module


def _encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        cls = type(obj)
        return {
            _TYPE_KEY: "@enum",
            "enum": f"{_json_module(cls.__module__)}:{cls.__qualname__}",
            "value": obj.name,
        }
    if isinstance(obj, (list, tuple)):
        enc = [_encode(v) for v in obj]
        if isinstance(obj, tuple):
            return {_TYPE_KEY: "@tuple", "items": enc}
        return enc
    if isinstance(obj, dict):
        return {str(k): _encode(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _CONFIG_REGISTRY:
            raise ValueError(
                f"{name} is not @register_config'd; cannot serialize polymorphically"
            )
        out: Dict[str, Any] = {_TYPE_KEY: name}
        for f in dataclasses.fields(obj):
            out[f.name] = _encode(getattr(obj, f.name))
        return out
    import numpy as np

    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return {_TYPE_KEY: "@ndarray", "data": obj.tolist(), "dtype": str(obj.dtype)}
    raise TypeError(f"Cannot serialize {type(obj)} to config JSON")


def _enum_class(name: str) -> type:
    if ":" in name:
        module, qualname = name.split(":", 1)
        obj: Any = importlib.import_module(_port_module(module))
        for part in qualname.split("."):
            obj = getattr(obj, part)
        return obj
    # legacy format: bare class name — search known enum subclasses
    for sub in _all_enum_subclasses(enum.Enum):
        if sub.__name__ == name and sub.__module__.startswith(_PORT_PACKAGE):
            return sub
    raise KeyError(f"Unknown enum class {name!r}")


def _all_enum_subclasses(cls: type) -> list:
    out = []
    for sub in cls.__subclasses__():
        out.append(sub)
        out.extend(_all_enum_subclasses(sub))
    return out


def _decode(obj: Any) -> Any:
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    if isinstance(obj, dict):
        tname = obj.get(_TYPE_KEY)
        if tname == "@enum":
            return _enum_class(obj["enum"])[obj["value"]]
        if tname == "@tuple":
            return tuple(_decode(v) for v in obj["items"])
        if tname == "@ndarray":
            import numpy as np

            return np.array(obj["data"], dtype=obj["dtype"])
        if tname is not None:
            cls = config_class(tname)
            kwargs = {k: _decode(v) for k, v in obj.items() if k != _TYPE_KEY}
            field_names = {f.name for f in dataclasses.fields(cls)}
            # Tolerate forward-compatible extra keys.
            kwargs = {k: v for k, v in kwargs.items() if k in field_names}
            return cls(**kwargs)
        return {k: _decode(v) for k, v in obj.items()}
    return obj


def to_json(cfg: Any, indent: int = 2) -> str:
    return json.dumps(_encode(cfg), indent=indent)


def from_json(s: str) -> Any:
    _register_all()
    return _decode(json.loads(s))


def _register_all() -> None:
    """Import every module that registers config classes, so that decoding
    a JSON document does not depend on what the caller imported first."""
    for mod in ("nn.conf", "nn.layers", "nn.weights", "nn.input_type",
                "train.schedules", "train.updaters"):
        importlib.import_module(f"{_PORT_PACKAGE}.{mod}")
