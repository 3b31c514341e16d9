"""Multi-level memory hierarchy (DEEP-ER §II-B) as first-class objects.

DEEP-ER's central hardware contribution is a memory/storage hierarchy:

    HBM/DDR (node)  >  node-local NVMe  >  NAM (fabric)  >  global storage

Each tier here has two faces:

  * **functional** — a byte store (directory- or memory-backed) that the
    I/O and checkpointing stack actually reads/writes in tests and runs;
  * **performance** — a bandwidth/latency model used by the benchmark
    harness to project paper-scale numbers (Figs 3-9) and by the roofline
    analysis to cost the checkpoint path on the TPU-v5e target.

Two built-in constant sets: ``DEEPER_TIERS`` carries the paper prototype's
measured characteristics (Table I, Fig 3); ``TPU_V5E_TIERS`` carries the
target fleet (197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s/link ICI, host DRAM
staging, object-store-class global storage).
"""

from __future__ import annotations

import dataclasses
import enum
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional


class TierKind(enum.Enum):
    HBM = "hbm"          # on-package memory (MCDRAM / TPU HBM)
    DRAM = "dram"        # node main memory
    NVM = "nvm"          # node-local non-volatile memory (DC P3700)
    NAM = "nam"          # network-attached memory (fabric-global)
    GLOBAL = "global"    # parallel file system / object store


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Performance characteristics of one tier (per node unless noted)."""

    kind: TierKind
    capacity_bytes: int
    read_bw: float            # bytes/s
    write_bw: float           # bytes/s
    latency_s: float          # per-operation setup latency
    shared: bool = False      # True if capacity/bandwidth are fabric-global

    def read_time(self, nbytes: int, streams: int = 1) -> float:
        """Model the time for `streams` concurrent readers of nbytes each.

        A shared tier divides its bandwidth across streams (the global
        file-system bottleneck in Fig 6); a local tier gives each stream
        its full bandwidth (the BeeOND/NVM scalability argument).
        """
        bw = self.read_bw / streams if self.shared else self.read_bw
        return self.latency_s + nbytes / bw

    def write_time(self, nbytes: int, streams: int = 1) -> float:
        bw = self.write_bw / streams if self.shared else self.write_bw
        return self.latency_s + nbytes / bw


# ---------------------------------------------------------------------- #
# Paper-prototype constants (Table I, Fig 3, §V measurements)
# ---------------------------------------------------------------------- #

GiB = 1024**3
TiB = 1024**4

DEEPER_TIERS: Dict[TierKind, TierSpec] = {
    # KNL MCDRAM: ~450 GB/s; "RAM on KNL is 75x faster than NVMe" (§V-A)
    TierKind.HBM: TierSpec(TierKind.HBM, 16 * GiB, 450e9, 450e9, 1e-7),
    TierKind.DRAM: TierSpec(TierKind.DRAM, 96 * GiB, 80e9, 80e9, 1e-7),
    # Intel DC P3700 400GB over PCIe gen3 x4: ~2.8 GB/s read, ~2.0 GB/s write
    TierKind.NVM: TierSpec(TierKind.NVM, 400 * GiB, 2.8e9, 2.0e9, 2e-5),
    # NAM: EXTOLL Tourmalet link speed, "very close to the best achievable
    # values on the network alone" (Fig 3): ~100 Gbit/s, ~1.8us latency.
    TierKind.NAM: TierSpec(TierKind.NAM, 2 * GiB, 11.5e9, 11.5e9, 1.8e-6, shared=True),
    # 2 storage servers + spinning disks: ~5 GB/s aggregate, shared.
    TierKind.GLOBAL: TierSpec(TierKind.GLOBAL, 57 * TiB, 5e9, 5e9, 5e-4, shared=True),
}

# Node-local spinning disk used for the Fig 7 NVMe-vs-HDD comparison.
# Rates are the paper's *application-level* throughputs (buffered
# sequential checkpoint writes): the Fig 7 NVMe/HDD gap is ~4.5x.
DEEPER_HDD = TierSpec(TierKind.GLOBAL, 4 * TiB, 0.5e9, 0.44e9, 8e-3)

# ---------------------------------------------------------------------- #
# TPU v5e target constants (per chip / per host)
# ---------------------------------------------------------------------- #

TPU_V5E_TIERS: Dict[TierKind, TierSpec] = {
    TierKind.HBM: TierSpec(TierKind.HBM, 16 * GiB, 819e9, 819e9, 1e-7),
    # host DRAM behind PCIe gen4 x16 per host (~25 GB/s effective D2H)
    TierKind.DRAM: TierSpec(TierKind.DRAM, 512 * GiB, 25e9, 25e9, 5e-6),
    # host-local NVMe staging
    TierKind.NVM: TierSpec(TierKind.NVM, 2 * TiB, 7e9, 5e9, 2e-5),
    # "NAM" equivalent on TPU = ICI-attached peers; 50 GB/s per link
    TierKind.NAM: TierSpec(TierKind.NAM, 16 * GiB, 50e9, 50e9, 1e-6, shared=True),
    # object-store-class global storage per-pod aggregate
    TierKind.GLOBAL: TierSpec(TierKind.GLOBAL, 100 * TiB, 20e9, 20e9, 2e-3, shared=True),
}


class CapacityError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class WallClockThrottle:
    """Opt-in *wall-clock* bandwidth emulation for a MemoryTier.

    The simulated tiers physically write to the page cache (CPU speed),
    which erases the very bottleneck the async machinery hides.  A
    throttle restores the physics: matching operations sleep
    ``nbytes / bw`` with the GIL released, so overlap measured by the
    benchmarks (fig6 BeeOND scaling, fig7 NVMe-vs-HDD, fig8 sync-vs-async
    drain) is real.  Modelled-time accounting is unaffected.

    ``key_prefix`` limits the throttle to bulk traffic (e.g. ``"ckpt/"``)
    so tiny index/descriptor records stay cheap, mirroring a real PFS.
    With ``shared=True`` the emulated bandwidth is divided across the
    ``streams`` concurrent writers of one operation — the global-file-
    system bottleneck of Fig 6 — while a local device gives every stream
    its full bandwidth.
    """

    write_bw: float                    # bytes/s of emulated wall bandwidth
    read_bw: Optional[float] = None    # None: reads are not throttled
    key_prefix: str = ""               # only throttle matching keys
    shared: bool = False               # divide bandwidth across streams

    def applies(self, key: str) -> bool:
        return key.startswith(self.key_prefix)

    def _sleep(self, nbytes: int, bw: float, streams: int) -> None:
        eff_bw = bw / max(1, streams) if self.shared else bw
        if nbytes > 0 and eff_bw > 0:
            time.sleep(nbytes / eff_bw)

    def sleep_write(self, key: str, nbytes: int, streams: int = 1) -> None:
        if self.applies(key):
            self._sleep(nbytes, self.write_bw, streams)

    def sleep_read(self, key: str, nbytes: int, streams: int = 1) -> None:
        if self.read_bw is not None and self.applies(key):
            self._sleep(nbytes, self.read_bw, streams)


class MemoryTier:
    """Functional byte store + the TierSpec performance model.

    Directory-backed when `backing_dir` is given (NVM/GLOBAL tiers — content
    must survive process restart), dict-backed otherwise (HBM/DRAM/NAM sim).
    Thread-safe: the BeeOND async drain and the async checkpoint writer
    touch tiers from worker threads.

    ``throttle`` opts into :class:`WallClockThrottle` emulation — sleeps
    happen *outside* the tier lock so a throttled bulk write never blocks
    concurrent metadata traffic.
    """

    def __init__(
        self,
        spec: TierSpec,
        backing_dir: Optional[Path] = None,
        throttle: Optional[WallClockThrottle] = None,
    ):
        self.spec = spec
        self.backing_dir = Path(backing_dir) if backing_dir is not None else None
        if self.backing_dir is not None:
            self.backing_dir.mkdir(parents=True, exist_ok=True)
        self.throttle = throttle
        self._mem: Dict[str, bytes] = {}
        self._lock = threading.RLock()
        # accumulated modelled time, for the paper-figure benchmarks
        self.modelled_read_s = 0.0
        self.modelled_write_s = 0.0

    # -- functional ---------------------------------------------------- #

    def _path(self, key: str) -> Path:
        assert self.backing_dir is not None
        p = self.backing_dir / key
        p.parent.mkdir(parents=True, exist_ok=True)
        return p

    def put(self, key: str, data: bytes, streams: int = 1) -> float:
        """Store bytes; returns *modelled* write time (seconds)."""
        t = self._put_locked(key, data, streams)
        # emulated wall cost only for *admitted* writes, outside the lock —
        # a CapacityError retry/spill must not pay the sleep
        if self.throttle is not None:
            self.throttle.sleep_write(key, len(data), streams)
        return t

    def _put_locked(self, key: str, data: bytes, streams: int = 1) -> float:
        with self._lock:
            if self.used_bytes() + len(data) > self.spec.capacity_bytes:
                raise CapacityError(
                    f"{self.spec.kind.value} tier over capacity "
                    f"({self.used_bytes() + len(data)} > {self.spec.capacity_bytes})"
                )
            if self.backing_dir is not None:
                self._path(key).write_bytes(data)
            else:
                self._mem[key] = bytes(data)
            t = self.spec.write_time(len(data), streams)
            self.modelled_write_s += t
            return t

    def put_stream(self, key: str, chunks, streams: int = 1) -> float:
        """Store an iterable of byte chunks without joining them first.

        Directory-backed tiers append chunk by chunk, so the full value is
        never held in one allocation (the streaming checkpoint-drain path);
        dict-backed tiers fall back to a single join.  Capacity is enforced
        against the running total; the write lands in a temp file renamed
        into place on success, so overflow never leaves a torn value and
        never destroys a pre-existing value under the same key.

        The emulated wall-clock sleep (``throttle=``) happens after the
        write is admitted, outside the lock — overflow never pays it.
        """
        with self._lock:
            budget = self.spec.capacity_bytes - self.used_bytes()
            total = 0
            if self.backing_dir is not None:
                path = self._path(key)
                tmp = path.parent / (path.name + ".inflight")
                try:
                    with open(tmp, "wb") as f:
                        for chunk in chunks:
                            total += len(chunk)
                            if total > budget:
                                raise CapacityError(
                                    f"{self.spec.kind.value} tier over capacity "
                                    f"(streamed {total} > budget {budget})"
                                )
                            f.write(chunk)
                    tmp.replace(path)
                except BaseException:
                    tmp.unlink(missing_ok=True)
                    raise
            else:
                parts = []
                for chunk in chunks:
                    total += len(chunk)
                    if total > budget:
                        raise CapacityError(
                            f"{self.spec.kind.value} tier over capacity "
                            f"(streamed {total} > budget {budget})"
                        )
                    parts.append(bytes(chunk))
                self._mem[key] = b"".join(parts)
            t = self.spec.write_time(total, streams)
            self.modelled_write_s += t
        if self.throttle is not None:
            self.throttle.sleep_write(key, total, streams)
        return t

    def get(self, key: str, streams: int = 1) -> bytes:
        with self._lock:
            if self.backing_dir is not None:
                p = self.backing_dir / key
                if not p.exists():
                    raise KeyError(key)
                data = p.read_bytes()
            else:
                data = self._mem[key]
            self.modelled_read_s += self.spec.read_time(len(data), streams)
        if self.throttle is not None:
            self.throttle.sleep_read(key, len(data), streams)
        return data

    def get_stream(self, key: str, streams: int = 1, chunk_bytes: int = 1 << 20):
        """Yield the value in bounded pieces (the drain path's read side).

        Directory-backed tiers stream from the open file so the full value
        is never held in one allocation; dict-backed tiers yield slices of
        the stored bytes.  Modelled read time is accounted once, up front.
        """
        with self._lock:
            if self.backing_dir is not None:
                p = self.backing_dir / key
                if not p.exists():
                    raise KeyError(key)
                nbytes = p.stat().st_size
                f = open(p, "rb")
            else:
                data = self._mem[key]
                nbytes = len(data)
                f = None
            self.modelled_read_s += self.spec.read_time(nbytes, streams)
        if self.throttle is not None:
            self.throttle.sleep_read(key, nbytes, streams)
        if f is not None:
            try:
                while True:
                    piece = f.read(chunk_bytes)
                    if not piece:
                        return
                    yield piece
            finally:
                f.close()
        else:
            view = memoryview(data)
            for off in range(0, nbytes, chunk_bytes):
                yield bytes(view[off : off + chunk_bytes])

    def exists(self, key: str) -> bool:
        with self._lock:
            if self.backing_dir is not None:
                return (self.backing_dir / key).exists()
            return key in self._mem

    def delete(self, key: str) -> None:
        with self._lock:
            if self.backing_dir is not None:
                p = self.backing_dir / key
                if p.exists():
                    p.unlink()
            else:
                self._mem.pop(key, None)

    def keys(self) -> Iterator[str]:
        with self._lock:
            if self.backing_dir is not None:
                for p in sorted(self.backing_dir.rglob("*")):
                    if p.is_file():
                        yield str(p.relative_to(self.backing_dir))
            else:
                yield from sorted(self._mem.keys())

    def used_bytes(self) -> int:
        with self._lock:
            if self.backing_dir is not None:
                return sum(p.stat().st_size for p in self.backing_dir.rglob("*") if p.is_file())
            return sum(len(v) for v in self._mem.values())

    def capacity_bytes(self) -> int:
        return self.spec.capacity_bytes

    def wipe(self) -> None:
        with self._lock:
            if self.backing_dir is not None:
                shutil.rmtree(self.backing_dir, ignore_errors=True)
                self.backing_dir.mkdir(parents=True, exist_ok=True)
            self._mem.clear()


class MemoryHierarchy:
    """Per-rank view of the full tier stack, built over a VirtualCluster."""

    def __init__(self, cluster, specs: Optional[Dict[TierKind, TierSpec]] = None):
        from repro_torch.cluster.topology import VirtualCluster  # local import, no cycle

        assert isinstance(cluster, VirtualCluster)
        self.cluster = cluster
        self.specs = dict(specs or DEEPER_TIERS)
        self._nvm: Dict[int, MemoryTier] = {}
        self.global_tier = MemoryTier(self.specs[TierKind.GLOBAL], cluster.global_dir)
        self.nam_tier = MemoryTier(self.specs[TierKind.NAM], cluster.nam_dir)
        # BeeOND cache domain: the node-local NVMs aggregated into one
        # shared staging store in front of global storage (§III-C).  Dict-
        # backed on purpose — cache content does not survive a process
        # restart; the drained global copy is the durable one.
        nvm = self.specs[TierKind.NVM]
        self.beeond_tier = MemoryTier(dataclasses.replace(
            nvm, capacity_bytes=nvm.capacity_bytes * max(1, cluster.size)))

    def nvm(self, rank: int) -> MemoryTier:
        """Node-local NVM tier; raises NodeFailure if that node is down."""
        path = self.cluster.nvm_path(rank)  # validates liveness
        tier = self._nvm.get(rank)
        if tier is None or tier.backing_dir != path:
            tier = MemoryTier(self.specs[TierKind.NVM], path)
            self._nvm[rank] = tier
        return tier

    def invalidate(self, rank: int) -> None:
        """Drop the cached tier handle after a node failure/recovery."""
        self._nvm.pop(rank, None)
