"""Persistent tile-plan cache: measured winners, keyed per kernel cell.

The port of ``repro.tuning.cache``, with the same file: one JSON object
``{"version": 1, "entries": {key: entry}}``, the key
``"<op_kind>:m<m>:k<k>:n<n>:<dtype>:<backend>"``.  The backend is
``"cuda"``, so a TPU or interpret-mode entry written by the JAX package
never matches a key of the port, nor the port's one of JAX's.

An entry holds a kernel's choice fields as its planner names them
(``BM``/``BN``/``split`` of ``kraken_gemm``, ``splits`` of
``paged_decode_attention``, ``BM``/``split`` of ``grouped_moe_gemm``,
``BN``/``split`` of ``kraken_conv2d_direct``), the planner's estimate
``est``, ``measured_us``, the planner's own pick ``model_pick`` (its choice
fields, estimate and time), ``agrees_with_model`` and ``candidates_timed``;
and the guards a hit must match (``page_size`` for ``paged_decode``,
``experts`` for ``moe_gemm``, as in JAX, and the fields
:mod:`repro_torch.tuning.search` adds).  What an entry's choice means is
checked on lookup against the planner's candidates
(:func:`repro_torch.tuning.search.lookup`), never here.

A corrupt file or a version mismatch is ignored with a warning -- a stale
cache must never take down a serving job -- and writes are atomic (a
temporary file, then a rename).
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings

CACHE_VERSION = 1

#: the environment's cache location; ``--tile-cache`` and
#: ``TileCache(path=...)`` take precedence
CACHE_PATH_ENV = "KRAKEN_TILE_CACHE"

#: the backend of every key the port writes and reads
BACKEND = "cuda"


def cache_key(op_kind: str, m: int, k: int, n: int, dtype_name: str,
              backend: str = BACKEND) -> str:
    """The identity of one tuned cell (see the schema above)."""
    return f"{op_kind}:m{m}:k{k}:n{n}:{dtype_name}:{backend}"


def default_cache_path() -> str | None:
    return os.environ.get(CACHE_PATH_ENV) or None


class TileCache:
    """Versioned JSON store of measured tile plans, with hit/miss counters.

    ``path=None`` keeps the cache in the process only.  The constructor
    loads the file; :meth:`save` writes it (the autotuner saves after every
    newly tuned cell, so a crashed warm-up loses at most one measurement).
    ``resolved`` memoizes the choices validated from this cache for the hot
    path; every change to ``entries`` through :meth:`put` or :meth:`load`
    clears it.
    """

    def __init__(self, path: str | None = None):
        self.path = path if path is not None else default_cache_path()
        self.entries: dict[str, dict] = {}
        self.resolved: dict = {}
        self.hits = 0
        self.misses = 0
        if self.path and os.path.isdir(self.path):
            warnings.warn(f"tile cache path {self.path!r} is a directory; "
                          "persistence disabled", stacklevel=2)
            self.path = None
        if self.path:
            self.load()

    # -- persistence --------------------------------------------------------

    def load(self) -> None:
        self.resolved.clear()
        if not self.path or not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            warnings.warn(f"tile cache {self.path!r} unreadable ({e}); "
                          "starting empty", stacklevel=2)
            return
        if not isinstance(blob, dict) or blob.get("version") != CACHE_VERSION:
            warnings.warn(
                f"tile cache {self.path!r} has version "
                f"{blob.get('version') if isinstance(blob, dict) else '?'} "
                f"(want {CACHE_VERSION}); ignoring it", stacklevel=2)
            return
        entries = blob.get("entries")
        if not isinstance(entries, dict):
            warnings.warn(f"tile cache {self.path!r} malformed entries; "
                          "starting empty", stacklevel=2)
            return
        self.entries = entries

    def save(self) -> None:
        if not self.path:
            return
        blob = {"version": CACHE_VERSION, "entries": self.entries}
        tmp = None
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".tile_cache.")
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError as e:
            # persistence is best-effort: a bad path or a full disk must not
            # take down the job that was only remembering its plans
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
            warnings.warn(f"tile cache {self.path!r} not saved ({e}); "
                          "continuing without persistence", stacklevel=2)

    # -- lookup -------------------------------------------------------------

    def peek(self, key: str) -> dict | None:
        """The raw entry, the hit/miss counters untouched."""
        entry = self.entries.get(key)
        return entry if isinstance(entry, dict) else None

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = entry
        self.resolved.clear()

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def stats(self) -> str:
        return (f"{self.hits} hits, {self.misses} misses, "
                f"{len(self.entries)} entries")
