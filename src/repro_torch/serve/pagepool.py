"""DevicePagePool: one pooled device KV buffer + a host-side page allocator.

Counterpart of ``repro/serve/pagepool.py``.  Every stream's KV lives in
one shared device buffer per cache leaf, laid out as physical pages of
``page_tokens`` tokens:

    leaf (L, B=1, S, *rest)  ->  pool (L, 1+N, page_tokens, *rest)

A stream is a row of a page *table* (logical page j -> physical slot);
``paged_decode_step`` reads and writes straight through the tables, so
admit / park / resume are host-side bookkeeping on this allocator.
Physical slot 0 is the *trash page*: inactive scheduler lanes point their
whole table at it, so their discarded writes never land in a live
stream's pages.  The allocator (free list order, refcounts, digest map)
behaves exactly as the reference's.

Page I/O (the park, spill, prefix and checkpoint paths, never the decode
loop) writes pages in place into the device leaves and reads them with
one device-to-host copy per leaf.  A page blob is the page's leaves in
sorted name order, in the decoded template dtype, bfloat16 as its raw
16-bit patterns: the reference's layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.io.serialization import _TORCH_DTYPES, _leaf_bytes, _leaf_from
from repro_torch.memory.codecs import (SCALE_SUFFIX, int8_dequantize,
                                       int8_quantize)
from repro_torch.memory.tiers import CapacityError

TRASH_PAGE = 0


class DevicePagePool:
    """Fixed-capacity pool of KV pages on ``device`` + host allocator.

    ``lane_template`` is one lane's cache (``model.init_cache(cfg, 1,
    max_len)``; only shapes and dtypes are read); every leaf must be laid out ``(layers, batch=1,
    kv_seq, *rest)`` (``model.cache_axes``).  ``n_pages`` is the physical
    capacity excluding the trash page.  ``quantized=True`` holds each
    K/V leaf as int8 with one float32 scale per last-axis channel in a
    ``<name>__scale`` companion leaf; page I/O stays in decoded
    template-dtype values (quantized on write, dequantized on read).
    """

    def __init__(self, lane_template: Any, axes: Any, page_tokens: int,
                 n_pages: int, quantized: bool = False, device="cuda"):
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        if n_pages < 1:
            raise ValueError("n_pages must be >= 1")
        leaves: Dict[str, torch.Tensor] = {}
        max_len = None
        dtypes: Dict[str, torch.dtype] = {}
        for name in sorted(lane_template):   # transformer caches are flat dicts
            leaf, ax = lane_template[name], axes[name]
            if not isinstance(leaf, torch.Tensor):
                raise ValueError("pool requires a flat dict cache layout")
            if name.endswith(SCALE_SUFFIX):
                raise ValueError(
                    f"leaf name {name} collides with the scale-buffer suffix")
            if len(ax) < 3 or ax[0] != "layers" or ax[2] != "kv_seq":
                raise ValueError(
                    f"leaf {name}: pool needs (layers, batch, kv_seq, ...) "
                    f"layout, got axes {ax}")
            n_layers, b, s = leaf.shape[:3]
            if b != 1:
                raise ValueError("lane_template must be batch-1")
            if s % page_tokens:
                raise ValueError(
                    f"max_len {s} not a multiple of page_tokens {page_tokens}")
            if max_len is not None and s != max_len:
                raise ValueError("cache leaves disagree on kv_seq length")
            if quantized and leaf.dim() < 4:
                raise ValueError(
                    f"leaf {name}: quantized mode needs a channel axis "
                    f"after kv_seq, got shape {tuple(leaf.shape)}")
            max_len = s
            dtypes[name] = leaf.dtype
            shape = (n_layers, 1 + n_pages, page_tokens) + tuple(leaf.shape[3:])
            if quantized:
                leaves[name] = torch.zeros(shape, dtype=torch.int8, device=device)
                leaves[name + SCALE_SUFFIX] = torch.zeros(
                    shape[:-1], dtype=torch.float32, device=device)
            else:
                leaves[name] = torch.zeros(shape, dtype=leaf.dtype, device=device)
        self.leaves: Dict[str, torch.Tensor] = leaves
        self.quantized = bool(quantized)
        self.dtypes = dtypes
        self.data_names = sorted(dtypes)
        self.page_tokens = int(page_tokens)
        self.n_pages = int(n_pages)
        self.max_len = int(max_len)
        self.pages_per_lane = self.max_len // self.page_tokens
        # logical page size: decoded bytes
        self.page_nbytes = sum(
            leaves[n][0, 0].numel() * dtypes[n].itemsize * leaves[n].shape[0]
            for n in self.data_names)
        # physical page size: what one page costs on device
        self.page_device_nbytes = sum(
            l[0, 0].numel() * l.element_size() * l.shape[0]
            for l in leaves.values())
        self._refs: Dict[int, int] = {}            # phys -> refcount
        self._free: List[int] = list(range(1, 1 + n_pages))
        self._digest_phys: Dict[str, int] = {}     # prefix digest -> phys

    # -- allocator --------------------------------------------------------- #

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` physical pages (refcount 1 each); all-or-nothing."""
        if n > len(self._free):
            raise CapacityError(
                f"pool exhausted: want {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for phys in out:
            self._refs[phys] = 1
        return out

    def ref(self, phys: int) -> None:
        assert phys != TRASH_PAGE and phys in self._refs, phys
        self._refs[phys] += 1

    def deref(self, phys: int) -> None:
        if phys == TRASH_PAGE:
            return
        self._refs[phys] -= 1
        if self._refs[phys] <= 0:
            del self._refs[phys]
            self._free.append(phys)

    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, phys: int) -> int:
        return self._refs.get(phys, 0)

    def refcounts(self) -> Dict[int, int]:
        """Every allocated page's refcount (checkpoint meta)."""
        return dict(sorted(self._refs.items()))

    # -- prefix-page residency --------------------------------------------- #

    def bind_digest(self, digest: str, phys: int) -> None:
        """Pin a physical page as the pool-resident copy of a prefix
        digest (holds one reference until :meth:`drop_digest`)."""
        assert digest not in self._digest_phys
        self.ref(phys)
        self._digest_phys[digest] = phys

    def lookup_digest(self, digest: str) -> Optional[int]:
        return self._digest_phys.get(digest)

    def drop_digest(self, digest: str) -> None:
        phys = self._digest_phys.pop(digest, None)
        if phys is not None:
            self.deref(phys)

    def resident_digests(self) -> Dict[str, int]:
        return dict(self._digest_phys)

    # -- page I/O (park/spill paths only — never the decode hot loop) ------ #

    def _store_decoded(self, phys: int, name: str, arr: Any,
                       n: Optional[int] = None) -> None:
        """Write one leaf's decoded page slice (L, n, *rest) — the first
        ``n`` tokens of slot ``phys``, the whole page by default —
        quantizing per channel (last axis) on the device in quantized
        mode."""
        leaf = self.leaves[name]
        n = self.page_tokens if n is None else n
        src = torch.as_tensor(arr).to(leaf.device)
        if self.quantized:
            q, scale = int8_quantize(src, axis=-1)
            leaf[:, phys, :n] = q
            self.leaves[name + SCALE_SUFFIX][:, phys, :n] = scale[..., 0]
        else:
            leaf[:, phys, :n] = src.to(leaf.dtype)

    def read_page(self, phys: int) -> Dict[str, torch.Tensor]:
        """One physical page's per-leaf host tensors, each (L, pt, *rest),
        always in the decoded template dtype."""
        out = {}
        for name in self.data_names:
            x = self.leaves[name][:, phys]
            if self.quantized:
                scale = self.leaves[name + SCALE_SUFFIX][:, phys]
                x = int8_dequantize(x, scale[..., None]).to(self.dtypes[name])
            out[name] = torch.empty(x.shape, dtype=x.dtype).copy_(x)
        return out

    def page_blob(self, phys: int) -> bytes:
        """One physical page as bytes (leaves concatenated in sorted name
        order, decoded even in quantized mode) — the interchange unit
        with the KVPager."""
        page = self.read_page(phys)
        return b"".join(_leaf_bytes(page[n])[0] for n in self.data_names)

    def write_page(self, phys: int, page: Dict[str, Any]) -> None:
        for name, arr in page.items():
            self._store_decoded(phys, name, arr)

    def _split_blob(self, blob: bytes) -> Dict[str, torch.Tensor]:
        """A page blob as per-leaf host tensors (L, pt, *rest)."""
        if len(blob) != self.page_nbytes:
            raise ValueError(
                f"page blob of {len(blob)} bytes != page size "
                f"{self.page_nbytes}")
        off = 0
        page = {}
        for name in self.data_names:
            leaf, dtype = self.leaves[name], self.dtypes[name]
            shape = [leaf.shape[0], self.page_tokens] + list(leaf.shape[3:])
            n = math.prod(shape) * dtype.itemsize
            entry = {"shape": shape, "dtype": _TORCH_DTYPES[dtype]}
            page[name] = _leaf_from(blob[off:off + n], entry, leaf)
            off += n
        return page

    def write_blob(self, phys: int, blob: bytes) -> None:
        self.write_page(phys, self._split_blob(blob))

    def write_token_slice(self, phys: int, part: Any) -> None:
        """Scatter a prefix-cache payload slice — leaves (L, 1,
        page_tokens, *rest) — into one physical page."""
        for name in self.data_names:
            self._store_decoded(phys, name, torch.as_tensor(part[name])[:, 0])

    def read_token_slice(self, phys: int) -> Any:
        """The inverse of :meth:`write_token_slice`: a prefix-cache
        payload (leaves (L, 1, page_tokens, *rest)) cut from one page."""
        return {name: arr[:, None]
                for name, arr in self.read_page(phys).items()}

    def blob_to_token_slice(self, blob: bytes) -> Any:
        """Reinterpret one page blob as a prefix-cache payload, without
        touching the device (a spilled stream's parked pages)."""
        return {name: arr[:, None]
                for name, arr in self._split_blob(blob).items()}

    def write_token_range(self, phys: int, part: Any, n: int) -> None:
        """Scatter the first ``n`` tokens of a page — a partial-page tail
        payload, leaves (L, 1, n, *rest) — into slot ``phys``.  Positions
        past ``n`` are untouched: they are stream-private, written by the
        owner's suffix prefill."""
        if not 0 < n <= self.page_tokens:
            raise ValueError(f"token range {n} outside (0, {self.page_tokens}]")
        for name in self.data_names:
            self._store_decoded(phys, name, torch.as_tensor(part[name])[:, 0],
                                n=n)

    def read_token_range(self, phys: int, n: int) -> Any:
        """The first ``n`` tokens of a page as a payload (leaves (L, 1, n,
        *rest)) — the tail-registration read."""
        if not 0 < n <= self.page_tokens:
            raise ValueError(f"token range {n} outside (0, {self.page_tokens}]")
        return {name: arr[:, None, :n]
                for name, arr in self.read_page(phys).items()}

    # -- checkpoint -------------------------------------------------------- #

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """The full pooled buffer on the host, byte-identical (trash page
        and unallocated slots included)."""
        return {name: l.detach().cpu().clone() for name, l in self.leaves.items()}

    def load(self, arrays: Dict[str, Any], refs: Dict[int, int],
             digest_phys: Dict[str, int]) -> None:
        for name, arr in arrays.items():
            leaf = self.leaves[name]
            src = torch.as_tensor(arr)
            if tuple(src.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"pool leaf {name}: snapshot shape {tuple(src.shape)} != "
                    f"pool shape {tuple(leaf.shape)}")
            leaf.copy_(src.to(leaf.dtype))
        self._refs = {int(k): int(v) for k, v in refs.items()}
        self._free = [p for p in range(1, 1 + self.n_pages)
                      if p not in self._refs]
        self._digest_phys = {str(d): int(p) for d, p in digest_phys.items()}

