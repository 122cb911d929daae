"""Persistent content-hashed result cache.

Every mapper search and every Study case is a pure function of value-type
inputs (frozen dataclasses all the way down: Device, MatmulShape, ModelConfig,
Plan, Workload, PrecisionPolicy, FusionPolicy). That makes results durable by
construction: hash the canonical form of the inputs plus a model-version salt,
and the answer from a previous process is exactly the answer this process
would compute. This module is the storage layer both caches share:

  * `canonical()` turns any value-type input into a deterministic, JSON-safe
    structure (dataclasses carry their class name, floats round-trip exactly
    via repr, numpy scalars collapse to python numbers);
  * `content_key()` hashes that structure (sha256) together with a salt —
    `MODEL_VERSION` must be bumped whenever any analytical cost model changes
    meaning, which invalidates every prior on-disk entry at once;
  * `DiskCache` is a namespace directory of one-JSON-file-per-entry under a
    two-hex-character fanout. Writes are atomic (temp file + os.replace in
    the same directory); reads tolerate corruption (a torn/garbage file is
    deleted and treated as a miss); every IO error degrades to "cache off"
    rather than an exception, so a read-only or full disk never breaks an
    evaluation.

Storage root: $REPRO_CACHE_DIR, else ~/.cache/repro-hwe. The layer is on by
default; disable globally with REPRO_DISK_CACHE=0 or `configure(enabled=
False)` (cold-start measurement uses the `disabled()` context manager).

The PyTorch port's copy of the JAX package's module, whole. The port's
caches keep namespaces of their own under the same root (``torch-mapper``,
``torch-cases``), so neither package serves an entry the other wrote.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from .obs import metrics

#: Bump on ANY semantic change to the analytical models (mapper cost model,
#: operator models, interconnect, precision, fusion/scheduling) — it salts
#: every content key, so old on-disk entries become unreachable instead of
#: silently stale.
MODEL_VERSION = "hwe-v7"

_ENV_DIR = "REPRO_CACHE_DIR"
_ENV_ENABLED = "REPRO_DISK_CACHE"

_FALSY = {"0", "false", "off", "no", ""}


def _env_enabled() -> bool:
    return os.environ.get(_ENV_ENABLED, "1").strip().lower() not in _FALSY


# module-level switches; None means "follow the environment"
_ENABLED_OVERRIDE: Optional[bool] = None
_ROOT_OVERRIDE: Optional[Path] = None


def cache_enabled() -> bool:
    """Is the persistent layer globally on?"""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    return _env_enabled()


def cache_root() -> Path:
    """Resolved storage root (not created until something is written)."""
    if _ROOT_OVERRIDE is not None:
        return _ROOT_OVERRIDE
    env = os.environ.get(_ENV_DIR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-hwe"


def configure(root: Optional[os.PathLike] = None,
              enabled: Optional[bool] = None) -> None:
    """Override storage root and/or the global on/off switch.

    Passing None leaves that setting untouched; `configure(root=...,
    enabled=...)` with explicit values wins over the REPRO_CACHE_DIR /
    REPRO_DISK_CACHE environment variables.
    """
    global _ROOT_OVERRIDE, _ENABLED_OVERRIDE
    if root is not None:
        _ROOT_OVERRIDE = Path(root)
    if enabled is not None:
        _ENABLED_OVERRIDE = bool(enabled)


@contextmanager
def disabled():
    """Temporarily force the persistent layer off (cold-start benchmarking)."""
    global _ENABLED_OVERRIDE
    prev = _ENABLED_OVERRIDE
    _ENABLED_OVERRIDE = False
    try:
        yield
    finally:
        _ENABLED_OVERRIDE = prev


@contextmanager
def overridden(root: Optional[os.PathLike] = None,
               enabled: Optional[bool] = None):
    """Temporarily override root and/or switch, restoring both on exit.

    Cold and warm measurements use this against a private temp directory
    without disturbing the user's real cache."""
    global _ROOT_OVERRIDE, _ENABLED_OVERRIDE
    prev = (_ROOT_OVERRIDE, _ENABLED_OVERRIDE)
    if root is not None:
        _ROOT_OVERRIDE = Path(root)
    if enabled is not None:
        _ENABLED_OVERRIDE = bool(enabled)
    try:
        yield
    finally:
        _ROOT_OVERRIDE, _ENABLED_OVERRIDE = prev


# ---------------------------------------------------------------------------
# canonical hashing
# ---------------------------------------------------------------------------

def canonical(obj: Any) -> Any:
    """Deterministic JSON-safe form of a value-type input.

    Dataclasses serialize as [classname, {field: canonical(value)}] so two
    different spec types with equal fields never collide; floats go through
    repr (exact round-trip); tuples/lists/dicts recurse. Raises TypeError on
    anything non-value-like (functions, arrays, open handles) — such inputs
    must not silently hash by id.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [type(obj).__name__,
                {f.name: canonical(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)}]
    if isinstance(obj, bool) or obj is None or isinstance(obj, (int, str)):
        return obj
    if isinstance(obj, float):
        # through float() first: np.float64 is a float subclass whose repr
        # is version-dependent ("np.float64(0.5)" under numpy 2)
        return repr(float(obj))
    if isinstance(obj, (tuple, list)):
        return [canonical(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): canonical(v) for k, v in sorted(obj.items())}
    # numpy scalars and other number-likes
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):
        return canonical(obj.item())
    raise TypeError(f"cannot canonicalize {type(obj).__name__} for a "
                    f"content-hashed cache key: {obj!r}")


def content_key(*parts: Any, salt: str = MODEL_VERSION) -> str:
    """sha256 hex of the canonical form of `parts`, salted by the model
    version (stale-salt entries are simply unreachable keys)."""
    blob = json.dumps([salt, [canonical(p) for p in parts]],
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# the on-disk store
# ---------------------------------------------------------------------------

@dataclass
class DiskCacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    corrupt: int = 0        # unreadable entries dropped on read
    errors: int = 0         # IO failures silently degraded to miss/no-op

    def summary(self) -> str:
        return (f"disk_hits={self.hits} disk_misses={self.misses} "
                f"disk_puts={self.puts} corrupt={self.corrupt} "
                f"io_errors={self.errors}")


class DiskCache:
    """One namespace of the persistent store: content-key -> JSON document.

    Layout: <root>/<namespace>/<key[:2]>/<key>.json. All writes are atomic
    (same-directory temp + os.replace); all reads are corruption-tolerant.
    A DiskCache constructed while the global switch is off (or pointing at
    an unwritable root) behaves as an always-miss, swallow-writes cache.

    Concurrency contract (relied on by `Study.run(workers=N)`):
    keys are content hashes, so two processes can only ever race on a key
    by writing the SAME bytes; with each write staged in the destination
    directory and published by `os.replace`, readers see either a complete
    previous document or a complete identical one — never a torn file —
    and last-writer-wins is a no-op. No cross-process locking is needed.
    """

    def __init__(self, namespace: str, root: Optional[os.PathLike] = None,
                 enabled: Optional[bool] = None) -> None:
        self.namespace = namespace
        self._root = Path(root) if root is not None else None
        self._enabled = enabled
        self.stats = DiskCacheStats()

    def _bump(self, what: str) -> None:
        # local per-namespace stats stay the API; the process-wide registry
        # (core/obs.py) gets a mirrored monotone counter for reporting
        setattr(self.stats, what, getattr(self.stats, what) + 1)
        metrics().inc(f"cache.{self.namespace}.{what}")

    @property
    def enabled(self) -> bool:
        return cache_enabled() if self._enabled is None else self._enabled

    @property
    def directory(self) -> Path:
        root = self._root if self._root is not None else cache_root()
        return root / self.namespace

    def _path(self, key: str) -> Path:
        return self.directory / key[:2] / f"{key}.json"

    # ------------------------------------------------------------------
    def get(self, key: str) -> Optional[dict]:
        if not self.enabled:
            return None
        path = self._path(key)
        try:
            with open(path, "r") as f:
                doc = json.load(f)
        except FileNotFoundError:
            self._bump("misses")
            return None
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
            # torn write or bit rot: drop the entry, miss
            self._bump("corrupt")
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        except OSError:
            self._bump("errors")
            return None
        if not isinstance(doc, dict):
            self._bump("corrupt")
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self._bump("hits")
        return doc

    def put(self, key: str, doc: dict) -> None:
        if not self.enabled:
            return
        path = self._path(key)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(doc, f, separators=(",", ":"))
                os.replace(tmp, path)       # atomic on POSIX
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self._bump("puts")
        except OSError:
            self._bump("errors")          # read-only / full disk: degrade

    def clear(self) -> None:
        """Remove every entry of this namespace from disk."""
        try:
            shutil.rmtree(self.directory)
        except FileNotFoundError:
            pass
        except OSError:
            self._bump("errors")

    def __len__(self) -> int:
        try:
            return sum(1 for _ in self.directory.glob("??/*.json"))
        except OSError:
            return 0
