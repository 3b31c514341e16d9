"""libNAM: access layer for the Network Attached Memory (DEEP-ER §II-B2).

The NAM is an FPGA+HMC board sitting directly on the EXTOLL fabric: a
memory pool globally addressable by every node via RDMA, with *no CPU on
the remote side* and with near-memory logic (the FPGA) able to pull data
from nodes and compute checkpoint parity locally.

This module reproduces libNAM's semantics over a MemoryTier:

* region allocation on the pool (capacity-checked against the HMC size),
* ``put``/``get`` through send/receive **ring buffers** with the
  EXTOLL-style *notification* mechanism (a completion record per
  transfer frees the buffer slot),
* ``offload_parity`` — the FPGA function: the NAM pulls fragments and
  XORs them into a parity region without the data crossing any node's
  storage path (the mechanism behind the Fig 9 NAM-XOR advantage),
* a transfer-time model (fabric bandwidth/latency, two Tourmalet links)
  used by the paper-figure benchmarks.

On the TPU target the *performance* role of the NAM is played by the ICI
fabric itself (see distributed/collectives.py: on-device XOR butterfly);
this functional simulator is what the SCR NAM_XOR strategy and the tests
run against.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

from repro_torch.core import parity
from repro_torch.memory.tiers import MemoryTier, TierSpec, TierKind


@dataclasses.dataclass
class Notification:
    """EXTOLL-style completion record posted after a put/get."""

    op: str          # "put" | "get" | "parity"
    region: str
    nbytes: int
    seq: int


@dataclasses.dataclass
class _Region:
    name: str
    size: int


class NAMDevice:
    """One NAM board: memory pool + ring buffers + near-memory parity."""

    def __init__(
        self,
        tier: MemoryTier,
        n_links: int = 2,
        link_bw: float = 11.5e9,     # ~100 Gbit/s Tourmalet payload rate
        latency_s: float = 1.8e-6,
        hmc_bw: float = 160e9,       # near-memory XOR pass runs at HMC speed
        ring_slots: int = 64,
    ):
        self.tier = tier
        self.n_links = n_links
        self.link_bw = link_bw
        self.hmc_bw = hmc_bw
        self.latency_s = latency_s
        self._regions: Dict[str, _Region] = {}
        self._notifications: Deque[Notification] = deque()
        self._ring = threading.Semaphore(ring_slots)
        self._ring_slots = ring_slots
        self._seq = 0
        self._lock = threading.Lock()
        self.modelled_busy_s = 0.0

    # -- pool management ------------------------------------------------ #

    def alloc(self, name: str, size: int) -> None:
        with self._lock:
            used = sum(r.size for r in self._regions.values())
            if used + size > self.tier.spec.capacity_bytes:
                raise MemoryError(
                    f"NAM pool exhausted: {used + size} > {self.tier.spec.capacity_bytes}"
                )
            self._regions[name] = _Region(name, size)

    def free(self, name: str) -> None:
        with self._lock:
            self._regions.pop(name, None)
        for key in list(self.tier.keys()):
            if key.startswith(f"{name}/") or key == name:
                self.tier.delete(key)

    def _check_region(self, name: str, nbytes: int) -> None:
        region = self._regions.get(name)
        if region is None:
            raise KeyError(f"NAM region {name!r} not allocated")
        if nbytes > region.size:
            raise ValueError(f"{nbytes} bytes exceed region {name!r} ({region.size})")

    def _notify(self, op: str, region: str, nbytes: int) -> Notification:
        with self._lock:
            self._seq += 1
            note = Notification(op, region, nbytes, self._seq)
            self._notifications.append(note)
        return note

    def poll(self) -> Optional[Notification]:
        """Consume the oldest completion notification (frees ring space)."""
        with self._lock:
            return self._notifications.popleft() if self._notifications else None

    # -- RMA-style transfers --------------------------------------------- #

    def transfer_time(self, nbytes: int, concurrent: int = 1) -> float:
        """Fabric model: concurrent streams share the NAM's link budget."""
        eff_bw = self.link_bw * self.n_links / max(1, concurrent)
        return self.latency_s + nbytes / eff_bw

    def put(self, region: str, data: bytes, concurrent: int = 1) -> float:
        self._check_region(region, len(data))
        self._ring.acquire()  # ring-buffer slot; freed by the notification
        try:
            self.tier.put(region, data)
            t = self.transfer_time(len(data), concurrent)
            self.modelled_busy_s += t
            self._notify("put", region, len(data))
            return t
        finally:
            self._ring.release()

    def get(self, region: str, concurrent: int = 1) -> bytes:
        self._ring.acquire()
        try:
            data = self.tier.get(region)
            self.modelled_busy_s += self.transfer_time(len(data), concurrent)
            self._notify("get", region, len(data))
            return data
        finally:
            self._ring.release()

    def exists(self, region: str) -> bool:
        return self.tier.exists(region)

    # -- near-memory compute (the FPGA logic) ---------------------------- #

    def offload_parity(
        self,
        out_region: str,
        sources: Sequence[Callable[[], bytes]],
        nbytes: int,
    ) -> float:
        """Pull fragments from `sources` and store their XOR parity.

        The pulls ride the fabric concurrently (the NAM is the sink for
        all of them, so they share its links); the XOR itself runs at
        memory speed on the device and is not the bottleneck — exactly
        the paper's offload argument.  Returns modelled wall seconds.
        """
        self._check_region(out_region, nbytes)
        fragments = [src() for src in sources]
        par = parity.encode_nam_parity(fragments)
        self.tier.put(out_region, par)
        # G concurrent pulls share the NAM's aggregate link bandwidth:
        # total bytes G*nbytes over n_links*link_bw, one latency.
        total = nbytes * len(fragments)
        t = self.latency_s + total / (self.link_bw * self.n_links)
        # single pass over the pulled data at HMC speed for the XOR
        t += total / self.hmc_bw
        self.modelled_busy_s += t
        self._notify("parity", out_region, nbytes)
        return t


def make_nam(tier: MemoryTier, **kw) -> NAMDevice:
    return NAMDevice(tier, **kw)
