"""SIONlib-style aggregated container files (DEEP-ER §III-C).

SIONlib's insight: parallel file systems handle *one large shared file*
far better than *N task-local files* (metadata pressure, lock contention,
small unaligned writes).  SIONlib therefore bundles all task-local streams
of the ranks on a node into a single container with per-rank chunk indexing
and filesystem-block alignment.

``SionContainer`` reproduces that format over a MemoryTier byte store:

    [ magic | version | align | n_chunks | index_offset ]   (header, 40 B)
    [ chunk 0 (padded to align) ][ chunk 1 ] ...
    [ JSON index: per chunk -> (rank, name, offset, nbytes) ]

One container replaces N per-rank keys; the per-figure benchmark
(fig5_sion) measures exactly the paper's N-files-vs-container delta.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Tuple

from repro_torch.memory.tiers import MemoryTier

_MAGIC = b"SION"
_VERSION = 2
_HEADER = struct.Struct("<4sIQQQ")  # magic, version, align, n_chunks, index_offset


class SionContainer:
    """Build (in memory) and persist an aggregated multi-writer container."""

    def __init__(self, align: int = 4096):
        if align < 1:
            raise ValueError("align must be positive")
        self.align = align
        # each entry holds the chunk's pieces un-joined until seal time, so
        # streamed writers never pay an intermediate per-chunk join
        self._chunks: List[Tuple[int, str, List[bytes]]] = []
        self._index: Optional[List[Dict]] = None
        self._data: Optional[bytes] = None

    # -- write side ----------------------------------------------------- #

    def write_chunk(self, rank: int, name: str, data: bytes) -> None:
        if self._data is not None:
            raise RuntimeError("container already sealed")
        data = data if isinstance(data, bytes) else bytes(data)
        self._chunks.append((rank, name, [data]))

    def write_chunk_stream(self, rank: int, name: str, pieces) -> None:
        """Accept one logical chunk as an iterable of byte pieces.

        The pieces are laid out contiguously at seal time; readers see one
        chunk, writers never build the joined buffer (the streaming-
        serialization path feeds leaf buffers straight through).
        """
        if self._data is not None:
            raise RuntimeError("container already sealed")
        self._chunks.append(
            (rank, name, [p if isinstance(p, bytes) else bytes(p) for p in pieces])
        )

    def seal(self) -> bytes:
        """Lay out chunks with alignment, append the index, return the blob."""
        if self._data is not None:
            return self._data
        body: List[bytes] = []
        index: List[Dict] = []
        offset = _HEADER.size
        for rank, name, pieces in self._chunks:
            pad = (-offset) % self.align
            if pad:
                body.append(b"\x00" * pad)
                offset += pad
            nbytes = sum(len(p) for p in pieces)
            index.append({"rank": rank, "name": name, "offset": offset, "nbytes": nbytes})
            body.extend(pieces)
            offset += nbytes
        index_blob = json.dumps(index, sort_keys=True).encode()
        header = _HEADER.pack(_MAGIC, _VERSION, self.align, len(index), offset)
        self._data = header + b"".join(body) + index_blob
        self._index = index
        return self._data

    def iter_sealed(self, chunk_bytes: int = 1 << 20):
        """Yield the sealed container in bounded pieces (streamed store)."""
        blob = memoryview(self.seal())
        for off in range(0, len(blob), chunk_bytes):
            yield blob[off : off + chunk_bytes]

    def store(self, tier: MemoryTier, key: str, streams: int = 1) -> float:
        """Persist the sealed container; returns modelled write seconds."""
        return tier.put(key, self.seal(), streams=streams)

    def store_stream(self, tier: MemoryTier, key: str, streams: int = 1) -> float:
        """Persist via the tier's streaming path (no second full copy)."""
        return tier.put_stream(key, self.iter_sealed(), streams=streams)

    # -- read side ------------------------------------------------------ #

    @classmethod
    def open(cls, tier: MemoryTier, key: str, streams: int = 1) -> "SionContainer":
        blob = tier.get(key, streams=streams)
        return cls.from_bytes(blob)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "SionContainer":
        magic, version, align, n_chunks, index_offset = _HEADER.unpack_from(blob, 0)
        if magic != _MAGIC:
            raise IOError("not a SION container")
        if version != _VERSION:
            raise IOError(f"unsupported SION version {version}")
        self = cls(align=align)
        self._data = blob
        self._index = json.loads(blob[index_offset:].decode())
        if len(self._index) != n_chunks:
            raise IOError("SION index corrupt")
        return self

    def _require_index(self) -> List[Dict]:
        if self._index is None:
            self.seal()
        assert self._index is not None
        return self._index

    def chunks(self) -> List[Tuple[int, str]]:
        return [(e["rank"], e["name"]) for e in self._require_index()]

    def read_chunk(self, rank: int, name: str) -> bytes:
        assert self._data is not None, "container not sealed/opened"
        for e in self._require_index():
            if e["rank"] == rank and e["name"] == name:
                return self._data[e["offset"] : e["offset"] + e["nbytes"]]
        raise KeyError((rank, name))

    def read_rank(self, rank: int) -> Dict[str, bytes]:
        assert self._data is not None, "container not sealed/opened"
        out = {}
        for e in self._require_index():
            if e["rank"] == rank:
                out[e["name"]] = self._data[e["offset"] : e["offset"] + e["nbytes"]]
        return out
