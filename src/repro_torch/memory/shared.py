"""SharedTier: a filesystem-backed BufferStore shared by processes.

Counterpart of ``repro/memory/shared.py``, with the same bytes on disk
(object files, ``manifest.json``, the lock file), so either package reads
and writes a domain the other wrote.

DEEP-ER's hierarchy stops being a per-node story exactly here: BeeOND
aggregates node-local NVM into one *cache domain* several nodes mount at
once (§II-B), and the DAOS line of work generalizes that to a shared
object store.  This module is that level for the serving fleet — a
directory several worker processes plug into their own
:class:`~repro_torch.memory.stack.TierStack` as a common bottom level, so a
content-addressed KV/prefix page demoted (or published) by worker A is
visible to worker B's read path and gets read-through-promoted into B's
fast tier by the ordinary stack machinery.

Correctness under concurrent access rests on two mechanisms:

* **Rename-commit object writes.**  A ``put`` writes the payload to a
  process/serial-unique temp file in the same directory and
  ``os.replace``s it over the final path.  Rename is atomic on POSIX, so
  a reader sees either the old complete object or the new complete
  object — never a torn mix.  (Same idiom as ``MemoryTier.put_stream``'s
  ``.inflight`` commit, promoted here to *every* write because peers may
  read at any moment.)
* **Advisory-locked manifest.**  A ``manifest.json`` in the domain root
  records every key's size and *publisher pids*.  All manifest updates
  run under an ``fcntl.flock`` on a lock file (gated: platforms without
  ``fcntl`` fall back to an ``O_EXCL`` spin lock) and are themselves
  rename-committed.  Publisher pids make ``delete`` safe across the
  fleet: each process's ``put`` registers it as a publisher, its
  ``delete`` only unregisters *itself*, and the object is unlinked only
  when the last publisher lets go — worker A evicting a prefix page it
  published cannot yank it out from under worker B's trie (B, who never
  published, deleting is a no-op on the shared copy).

A crashed publisher leaves its pid registered; that pins its objects
(garbage, not corruption).  :meth:`SharedTier.gc` reclaims them without
a daemon: any process may sweep the manifest under the domain lock and
unlink objects whose publishers have *all* exited and whose manifest
records are older than a TTL — the age guard keeps a freshly published
object of a just-crashed worker visible long enough for the frontend's
recovery path to restore from it before the space is reclaimed.
Consumers must tolerate objects vanishing between ``exists`` and
``get`` (a ``get`` of an unlinked object raises ``KeyError``): every
stack consumer already does, because a plain eviction races
identically.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

from repro_torch.memory.tiers import CapacityError, TierKind, TierSpec
from repro_torch.obs.metrics import Registry, StatsView

try:
    import fcntl
    _HAVE_FLOCK = True
except ImportError:          # pragma: no cover - non-POSIX fallback
    fcntl = None
    _HAVE_FLOCK = False

# shared-filesystem-class modelled performance: BeeOND-style aggregated
# node-local NVM (bandwidth between the paper's NVM and global tiers)
SHARED_SPEC = TierSpec(TierKind.NVM, 400 * (1024 ** 3), 2.8e9, 2.0e9,
                       2e-5, shared=True)


class _DomainLock:
    """Advisory exclusive lock on the domain (context manager)."""

    def __init__(self, path: Path):
        self.path = path
        self._fd: Optional[int] = None

    def __enter__(self) -> "_DomainLock":
        if _HAVE_FLOCK:
            self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        else:                 # pragma: no cover - non-POSIX fallback
            # O_EXCL spin: the lock file itself is the token
            while True:
                try:
                    self._fd = os.open(str(self.path) + ".excl",
                                       os.O_CREAT | os.O_EXCL | os.O_RDWR)
                    break
                except FileExistsError:
                    time.sleep(0.001)
        return self

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            if _HAVE_FLOCK:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
                os.close(self._fd)
            else:             # pragma: no cover
                os.close(self._fd)
                os.unlink(str(self.path) + ".excl")
            self._fd = None


class SharedTier:
    """One cross-process cache domain as a :class:`BufferStore`.

    Layout under ``root``::

        objs/<key>          committed payloads (rename-commit)
        manifest.json       {key: {"size": int, "pubs": [pid, ...],
                                   "t": last-publish unix time}}
        .lock               advisory lock file for manifest updates

    Any number of processes may construct a ``SharedTier`` over the same
    ``root`` concurrently; creation is idempotent.  ``accepts_spill`` is
    True — the router may demote cold KV pages here, which *is* the
    organic publish path (an explicit publish helper lives on
    ``TierStack.put_at``).
    """

    accepts_spill = True

    def __init__(self, root, capacity_bytes: int = 4 << 30,
                 spec: TierSpec = SHARED_SPEC,
                 registry: Optional[Registry] = None):
        self.root = Path(root)
        self.spec = spec
        self._capacity = int(capacity_bytes)
        self._objs = self.root / "objs"
        self._manifest_path = self.root / "manifest.json"
        self._lock_path = self.root / ".lock"
        self._objs.mkdir(parents=True, exist_ok=True)
        self._serial = 0
        self.registry = registry if registry is not None else Registry()
        self.gc_stats = StatsView(self.registry, "shared", {
            "gc_runs": 0, "gc_reclaimed": 0,
            "gc_reclaimed_bytes": 0, "gc_pinned_live": 0,
            "gc_pinned_young": 0})

    # -- paths ------------------------------------------------------------ #

    def _path(self, key: str) -> Path:
        parts = [p for p in key.split("/") if p not in ("", ".", "..")]
        if not parts:
            raise KeyError(key)
        return self._objs.joinpath(*parts)

    def _key_of(self, path: Path) -> str:
        return "/".join(path.relative_to(self._objs).parts)

    # -- manifest (always under the domain lock) -------------------------- #

    def _read_manifest(self) -> Dict[str, Dict]:
        try:
            with open(self._manifest_path, "rb") as f:
                return json.loads(f.read() or b"{}")
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _write_manifest(self, manifest: Dict[str, Dict]) -> None:
        tmp = self._manifest_path.with_name(
            f"manifest.{os.getpid()}.{self._serial}.tmp")
        self._serial += 1
        tmp.write_bytes(json.dumps(manifest, sort_keys=True).encode())
        os.replace(tmp, self._manifest_path)

    def manifest(self) -> Dict[str, Dict]:
        """A consistent manifest snapshot (for tests / introspection)."""
        with _DomainLock(self._lock_path):
            return self._read_manifest()

    # -- BufferStore ------------------------------------------------------- #

    def put(self, key: str, data: bytes, streams: int = 1) -> float:
        path = self._path(key)
        with _DomainLock(self._lock_path):
            manifest = self._read_manifest()
            entry = manifest.get(key)
            used = sum(e["size"] for e in manifest.values())
            if entry is not None:
                used -= entry["size"]
            if used + len(data) > self._capacity:
                raise CapacityError(
                    f"shared domain full: {used} + {len(data)} > "
                    f"{self._capacity}")
            pubs = list(entry["pubs"]) if entry else []
            if os.getpid() not in pubs:
                pubs.append(os.getpid())
            manifest[key] = {"size": len(data), "pubs": pubs,
                             "t": time.time()}
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(
                f"{path.name}.{os.getpid()}.{self._serial}.tmp")
            self._serial += 1
            tmp.write_bytes(data)
            os.replace(tmp, path)       # atomic commit: no torn reads
            self._write_manifest(manifest)
        return self.spec.write_time(len(data), streams)

    def put_stream(self, key: str, chunks, streams: int = 1) -> float:
        # commit must be atomic anyway, so the stream joins first
        return self.put(key, b"".join(bytes(c) for c in chunks),
                        streams=streams)

    def append(self, key: str, data: bytes) -> int:
        """Append ``data`` to an object in place; returns the object's
        new size.

        Deliberately NOT rename-commit — this is the journal seam the
        flight recorder (:mod:`repro_torch.obs.recorder`) flushes through,
        where crash semantics invert: a process killed mid-append may
        leave a torn final record, and every byte *before* the append
        is still intact precisely because nothing was rewritten.  The
        reader owns torn-tail tolerance (``read_flight`` drops
        unparsable lines); consumers needing atomic visibility use
        :meth:`put`.  Manifest bookkeeping (size, publisher pid,
        capacity check) runs under the domain lock like any write."""
        path = self._path(key)
        with _DomainLock(self._lock_path):
            manifest = self._read_manifest()
            entry = manifest.get(key)
            used = sum(e["size"] for e in manifest.values())
            if used + len(data) > self._capacity:
                raise CapacityError(
                    f"shared domain full: {used} + {len(data)} > "
                    f"{self._capacity}")
            pubs = list(entry["pubs"]) if entry else []
            if os.getpid() not in pubs:
                pubs.append(os.getpid())
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "ab") as f:
                f.write(data)
            size = path.stat().st_size
            manifest[key] = {"size": size, "pubs": pubs, "t": time.time()}
            self._write_manifest(manifest)
        self.spec.write_time(len(data), 1)
        return size

    def get(self, key: str, streams: int = 1) -> bytes:
        # lock-free read: rename-commit guarantees a complete object
        try:
            data = self._path(key).read_bytes()
        except (FileNotFoundError, IsADirectoryError):
            raise KeyError(key)
        self.spec.read_time(len(data), streams)
        return data

    def exists(self, key: str) -> bool:
        try:
            return self._path(key).is_file()
        except KeyError:
            return False

    def delete(self, key: str) -> None:
        """Unregister *this process* as a publisher; unlink only when no
        publisher remains.  Idempotent, and a no-op on the shared object
        for processes that never published it."""
        with _DomainLock(self._lock_path):
            manifest = self._read_manifest()
            entry = manifest.get(key)
            if entry is None:
                return
            pubs = [p for p in entry["pubs"] if p != os.getpid()]
            if pubs:
                manifest[key] = dict(entry, pubs=pubs)
            else:
                manifest.pop(key, None)
                try:
                    self._path(key).unlink()
                except FileNotFoundError:
                    pass
            self._write_manifest(manifest)

    # -- garbage collection ------------------------------------------------ #

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:   # pragma: no cover - alive, other user
            return True
        except (OverflowError, ValueError):
            return False
        return True

    def gc(self, ttl_s: float = 0.0, pid_alive=None,
           now: Optional[float] = None) -> Dict[str, int]:
        """Reclaim objects stranded by dead publishers.

        An object is collected iff **every** registered publisher pid has
        exited *and* its manifest record is older than ``ttl_s`` (records
        written before the timestamp upgrade count as infinitely old).
        The TTL is the consistency window: a worker that just crashed may
        have streams mid-recovery on a survivor reading its last epoch
        checkpoint from this domain, so callers pass a TTL comfortably
        above the fleet's checkpoint cadence + recovery time.  Runs
        entirely under the domain lock; any fleet member (typically the
        frontend, after a recovery) may call it.

        ``pid_alive`` injects a liveness oracle for tests; the default
        probes with ``os.kill(pid, 0)``.  Returns the per-call summary
        and accumulates :attr:`gc_stats`.
        """
        alive = pid_alive if pid_alive is not None else self._pid_alive
        t_now = time.time() if now is None else float(now)
        reclaimed = reclaimed_bytes = pinned_live = pinned_young = 0
        with _DomainLock(self._lock_path):
            manifest = self._read_manifest()
            live_cache: Dict[int, bool] = {}
            for key in list(manifest):
                entry = manifest[key]
                pubs = entry.get("pubs", [])
                if any(live_cache.setdefault(p, bool(alive(p)))
                       for p in pubs):
                    pinned_live += 1
                    continue
                age = t_now - float(entry.get("t", float("-inf")))
                if age <= ttl_s:
                    pinned_young += 1
                    continue
                manifest.pop(key)
                try:
                    self._path(key).unlink()
                except (FileNotFoundError, KeyError):
                    pass
                reclaimed += 1
                reclaimed_bytes += int(entry.get("size", 0))
            if reclaimed:
                self._write_manifest(manifest)
        out = {"gc_reclaimed": reclaimed,
               "gc_reclaimed_bytes": reclaimed_bytes,
               "gc_pinned_live": pinned_live,
               "gc_pinned_young": pinned_young}
        self.gc_stats["gc_runs"] += 1
        for k, v in out.items():
            self.gc_stats[k] += v
        return out

    def keys(self) -> Iterator[str]:
        found: List[str] = []
        for dirpath, _, files in os.walk(self._objs):
            base = Path(dirpath)
            for name in files:
                if name.endswith(".tmp"):
                    continue
                found.append(self._key_of(base / name))
        yield from sorted(found)

    def used_bytes(self) -> int:
        with _DomainLock(self._lock_path):
            return sum(e["size"] for e in self._read_manifest().values())

    def capacity_bytes(self) -> int:
        return self._capacity
