"""Versioned on-disk model artifact store (port of
``deeplearning4j_tpu/serving/store.py``).

The servable lifecycle — versioned artifacts, integrity checks, retention
— is a first-class subsystem in production serving stacks (PAPERS.md:
the TF-Serving style servable/session management in "TensorFlow: A
system for large-scale machine learning"). :class:`ModelStore` is that
subsystem over the single-file format of
:mod:`~deeplearning4j_tpu_torch.model.serializer`:

* **Monotonic versions per model name.** ``publish`` assigns ``v1, v2,
  ...``; a version directory is immutable once committed.
* **Atomic publish.** The artifact and its manifest are staged in a temp
  directory inside the model directory, fsynced, then ``os.replace``d to
  the final ``v<N>`` path — a crash mid-publish leaves no half-written
  version visible to ``resolve`` (stale staging dirs are swept by
  :meth:`gc`).
* **Integrity.** Each version's ``manifest.json`` records the SHA-256
  and size of ``model.zip``; :meth:`load` verifies it before
  deserializing, so bit-rot or a torn copy surfaces as
  :class:`ChecksumMismatchError` instead of a corrupt model.
* **Retention.** :meth:`gc` keeps the newest ``keep_last`` versions,
  never deletes the latest or any version in ``in_use`` (the versions a
  :class:`~deeplearning4j_tpu_torch.serving.manager.ModelManager` still has
  resident for rollback/pinning).

Store layout::

    <root>/<model_name>/v<N>/model.zip
    <root>/<model_name>/v<N>/manifest.json

Concurrency: safe for many threads in one process (a per-store lock
serializes version assignment). Multi-writer publishes from *separate
processes* to one store are not coordinated — front them with a single
publisher, as a production registry would.

The layout, the manifest's keys and the model zip are the JAX package's,
so a store either package publishes loads in the other (checksums
verified the same way). ``framework`` names the package that published a
version; models load onto the store's ``device`` (default: the current
CUDA device). Normalizers are not part of the port, so ``publish`` takes
none.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import torch

from .. import __version__
from ..model.serializer import restore_model, write_model

_ARTIFACT = "model.zip"
_MANIFEST = "manifest.json"
_VDIR_RE = re.compile(r"^v(\d+)$")
_STAGING_PREFIX = ".staging-"

LATEST = "latest"


class ModelStoreError(RuntimeError):
    """Base class for registry failures."""


class VersionNotFoundError(ModelStoreError, KeyError):
    """The requested model name / version is not in the store."""

    # KeyError.__str__ repr-quotes the message; keep plain text
    __str__ = BaseException.__str__


class ChecksumMismatchError(ModelStoreError):
    """The artifact's bytes do not match the manifest's SHA-256."""


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class ModelVersion:
    """One committed (name, version) entry: paths + manifest view."""

    __slots__ = ("name", "version", "path", "manifest")

    def __init__(self, name: str, version: int, path: str,
                 manifest: Dict) -> None:
        self.name = name
        self.version = int(version)
        self.path = path
        self.manifest = manifest

    @property
    def artifact_path(self) -> str:
        return os.path.join(self.path, _ARTIFACT)

    @property
    def sha256(self) -> str:
        return self.manifest["sha256"]

    @property
    def metadata(self) -> Dict:
        return self.manifest.get("metadata") or {}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ModelVersion({self.name!r}, v{self.version})"


def _coerce_version(version: Union[int, str]) -> Optional[int]:
    """``"latest"`` -> None; ``3`` / ``"3"`` / ``"v3"`` -> 3."""
    if isinstance(version, str):
        v = version.strip().lower()
        if v == LATEST:
            return None
        if v.startswith("v"):
            v = v[1:]
        if not v.isdigit():
            raise VersionNotFoundError(f"unparseable version {version!r}")
        return int(v)
    return int(version)


class ModelStore:
    def __init__(self, root: str, *, keep_last: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.root = os.path.abspath(root)
        self.keep_last = keep_last
        self.device = device
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()

    # ---- enumeration --------------------------------------------------
    def models(self) -> List[str]:
        out = []
        for entry in sorted(os.listdir(self.root)):
            if os.path.isdir(os.path.join(self.root, entry)) and \
                    not entry.startswith("."):
                out.append(entry)
        return out

    def _model_dir(self, name: str) -> str:
        if not name or "/" in name or os.sep in name or name.startswith("."):
            raise ModelStoreError(f"invalid model name {name!r}")
        return os.path.join(self.root, name)

    def _version_ids(self, name: str) -> List[int]:
        mdir = self._model_dir(name)
        if not os.path.isdir(mdir):
            return []
        ids = []
        for entry in os.listdir(mdir):
            m = _VDIR_RE.match(entry)
            # only committed versions count: a staged dir has no manifest
            if m and os.path.exists(os.path.join(mdir, entry, _MANIFEST)):
                ids.append(int(m.group(1)))
        return sorted(ids)

    def versions(self, name: str) -> List[ModelVersion]:
        return [self._entry(name, v) for v in self._version_ids(name)]

    def _entry(self, name: str, version: int) -> ModelVersion:
        vdir = os.path.join(self._model_dir(name), f"v{version}")
        mpath = os.path.join(vdir, _MANIFEST)
        if not os.path.exists(mpath):
            raise VersionNotFoundError(f"{name} v{version} not in store")
        with open(mpath) as f:
            manifest = json.load(f)
        return ModelVersion(name, version, vdir, manifest)

    def resolve(self, name: str,
                version: Union[int, str] = LATEST) -> ModelVersion:
        """Pinned or ``"latest"`` lookup of a committed version."""
        want = _coerce_version(version)
        if want is None:
            ids = self._version_ids(name)
            if not ids:
                raise VersionNotFoundError(f"no versions of {name!r} in store")
            want = ids[-1]
        return self._entry(name, want)

    # ---- publish ------------------------------------------------------
    def publish(self, name: str, model, *, save_updater: bool = False,
                metadata: Optional[Dict] = None) -> ModelVersion:
        """Serialize ``model`` as the next version of ``name``. Atomic:
        the version appears in the store fully-formed or not at all."""
        mdir = self._model_dir(name)
        os.makedirs(mdir, exist_ok=True)
        with self._lock:
            ids = self._version_ids(name)
            version = (ids[-1] + 1) if ids else 1
            final = os.path.join(mdir, f"v{version}")
            staging = tempfile.mkdtemp(prefix=_STAGING_PREFIX, dir=mdir)
            try:
                artifact = os.path.join(staging, _ARTIFACT)
                write_model(model, artifact, save_updater=save_updater)
                manifest = {
                    "model_name": name,
                    "version": version,
                    "sha256": _sha256_file(artifact),
                    "size_bytes": os.path.getsize(artifact),
                    "created_unix": time.time(),
                    "model_class": type(model).__name__,
                    "framework": "deeplearning4j_tpu_torch",
                    "framework_version": __version__,
                    "metadata": metadata or {},
                }
                mpath = os.path.join(staging, _MANIFEST)
                with open(mpath, "w") as f:
                    json.dump(manifest, f, indent=2, sort_keys=True)
                    f.flush()
                    os.fsync(f.fileno())
                _fsync_dir(staging)
                os.replace(staging, final)
                _fsync_dir(mdir)
            except BaseException:
                shutil.rmtree(staging, ignore_errors=True)
                raise
        return ModelVersion(name, version, final, manifest)

    # ---- load ---------------------------------------------------------
    def verify(self, entry: ModelVersion) -> None:
        """Raise :class:`ChecksumMismatchError` unless the artifact bytes
        match the manifest recorded at publish time."""
        actual = _sha256_file(entry.artifact_path)
        if actual != entry.sha256:
            raise ChecksumMismatchError(
                f"{entry.name} v{entry.version}: artifact sha256 {actual} "
                f"!= manifest {entry.sha256} — artifact corrupt or "
                f"tampered; refusing to load")

    def load(self, name: str, version: Union[int, str] = LATEST, *,
             load_updater: bool = False, verify: bool = True):
        """Resolve + integrity-check + deserialize onto the store's
        device. Returns ``(model, ModelVersion)``."""
        entry = self.resolve(name, version)
        if verify:
            self.verify(entry)
        model = restore_model(entry.artifact_path, self.device,
                              load_updater=load_updater)
        return model, entry

    # ---- retention / GC ----------------------------------------------
    def delete(self, name: str, version: Union[int, str]) -> None:
        entry = self.resolve(name, version)
        shutil.rmtree(entry.path)

    def gc(self, name: Optional[str] = None, *,
           keep_last: Optional[int] = None,
           in_use: Sequence[int] = ()) -> Dict[str, List[int]]:
        """Apply the retention policy: per model, keep the newest
        ``keep_last`` committed versions (default: the store's policy;
        ``None`` keeps everything). The latest version and any version in
        ``in_use`` are never collected. Stale staging directories from
        crashed publishes are always swept. Returns
        ``{model_name: [removed version ids]}``."""
        keep = keep_last if keep_last is not None else self.keep_last
        protected = {int(v) for v in in_use}
        removed: Dict[str, List[int]] = {}
        names = [name] if name is not None else self.models()
        with self._lock:
            for n in names:
                mdir = self._model_dir(n)
                if not os.path.isdir(mdir):
                    continue
                for entry in os.listdir(mdir):
                    if entry.startswith(_STAGING_PREFIX):
                        shutil.rmtree(os.path.join(mdir, entry),
                                      ignore_errors=True)
                ids = self._version_ids(n)
                if keep is None or len(ids) <= keep:
                    continue
                doomed = [v for v in ids[:-max(keep, 1)]
                          if v not in protected]
                for v in doomed:
                    shutil.rmtree(os.path.join(mdir, f"v{v}"))
                    removed.setdefault(n, []).append(v)
        return removed
