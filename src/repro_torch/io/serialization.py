"""Checkpoint serialization: state tree <-> byte blob <-> per-rank fragments.

Counterpart of ``repro/io/serialization.py``, producing the reference's
exact manifest and blob layout for the same state, so a checkpoint
written by either package restores in the other:

* **leaf order and names** follow JAX's pytree rules, not
  ``torch.utils._pytree``'s: dict keys are visited in sorted order, and a
  leaf is named by its key path as ``jax.tree_util.keystr`` writes it
  (``['params']['layers']['attn']['wq']``, ``[0]`` for a list index);
  the manifest's ``treedef`` is the string ``str(treedef)`` gives
  (``PyTreeDef({'opt': {...}, 'step': *})``);
* **leaves** may be torch tensors, numpy arrays or Python scalars; a
  bfloat16 tensor is written as its raw 16-bit patterns under the dtype
  name ``bfloat16`` (``Tensor.numpy()`` refuses bfloat16).

Restoring against a template rebuilds each leaf in the template leaf's
kind: a torch tensor (CPU) where the template holds a tensor, a numpy
array otherwise.  The byte partitioning is a copy of the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import zlib
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

ALIGN = 4  # fragment alignment: XOR kernels view data as int32 words

# manifest dtype names of torch dtypes (numpy's names, as the reference
# writes them)
_TORCH_DTYPES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_BY_NAME = {v: k for k, v in _TORCH_DTYPES.items()}


# ---------------------------------------------------------------------- #
# JAX-ordered flattening of nested dicts / lists / tuples
# ---------------------------------------------------------------------- #


def _flatten(tree: Any, path: Tuple = ()) -> Tuple[List[Tuple[Tuple, Any]], str]:
    """(key path, leaf) pairs in JAX's order, and the treedef string."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        out: List[Tuple[Tuple, Any]] = []
        parts = []
        for k in sorted(tree):
            sub, s = _flatten(tree[k], path + (("key", k),))
            out += sub
            parts.append(f"{k!r}: {s}")
        return out, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        out = []
        parts = []
        for i, v in enumerate(tree):
            sub, s = _flatten(v, path + (("idx", i),))
            out += sub
            parts.append(s)
        if isinstance(tree, list):
            return out, "[" + ", ".join(parts) + "]"
        return out, "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    return [(path, tree)], "*"


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _leaf_name(path: Tuple) -> str:
    return "".join(f"[{k!r}]" if kind == "key" else f"[{k}]"
                   for kind, k in path)


def _leaf_bytes(leaf: Any) -> Tuple[bytes, List[int], str]:
    """Raw bytes, shape and dtype name of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _TORCH_DTYPES.get(t.dtype)
        if name is None:
            raise TypeError(f"cannot serialize a {t.dtype} leaf")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return raw.numpy().tobytes(), list(t.shape), name
    arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), arr.dtype.name


def _leaf_from(raw: bytes, entry: Dict[str, Any], tmpl: Any) -> Any:
    """One restored leaf, in the template leaf's kind."""
    shape = entry["shape"]
    if isinstance(tmpl, torch.Tensor):
        dtype = _BY_NAME[entry["dtype"]]
        if dtype == torch.bfloat16:
            bits = torch.frombuffer(bytearray(raw), dtype=torch.int16)
            return bits.view(torch.bfloat16).reshape(shape)
        if not raw:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(entry["dtype"])).reshape(shape).copy()


def _shape_of(leaf: Any) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


# ---------------------------------------------------------------------- #
# blobs and streams
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class StateBlob:
    """A serialized state: raw bytes + manifest describing the layout."""

    data: bytes
    manifest: Dict[str, Any]

    @property
    def nbytes(self) -> int:
        return len(self.data)

    def manifest_bytes(self) -> bytes:
        return json.dumps(self.manifest, sort_keys=True).encode()


@dataclasses.dataclass
class StateStream:
    """A serialized state held as its ordered per-leaf buffers.

    The streaming counterpart of :class:`StateBlob`: the same logical byte
    sequence, but never joined into one contiguous allocation.  Fragments
    for the SCR strategy lattice are assembled directly from slices of the
    leaf buffers, so the only full-size materialization on the checkpoint
    path is the fragment list itself (one copy, not two).
    """

    parts: List[bytes]
    manifest: Dict[str, Any]

    @property
    def nbytes(self) -> int:
        return self.manifest["total_bytes"]

    def fragment_size(self, n_ranks: int) -> int:
        return compute_fragment_size(self.nbytes, n_ranks)

    def iter_chunks(self) -> Iterator[bytes]:
        """Yield the raw leaf buffers in blob order (zero-copy stream)."""
        yield from self.parts

    def iter_fragments(self, n_ranks: int) -> Iterator[bytes]:
        """Yield `n_ranks` equal, ALIGN-padded fragments.

        Identical output to ``partition_blob(join(parts), n_ranks)`` but
        assembled from memoryview slices of the leaf buffers — the full
        joined blob is never materialized.
        """
        frag = self.fragment_size(n_ranks)
        views = [memoryview(p) for p in self.parts if len(p)]
        vi, voff = 0, 0  # cursor into the logical byte sequence
        for _ in range(n_ranks):
            pieces: List[memoryview] = []
            need = frag
            while need and vi < len(views):
                take = min(need, len(views[vi]) - voff)
                pieces.append(views[vi][voff : voff + take])
                voff += take
                need -= take
                if voff == len(views[vi]):
                    vi, voff = vi + 1, 0
            out = b"".join(pieces)
            if len(out) < frag:
                out += b"\x00" * (frag - len(out))
            yield out

    def fragments(self, n_ranks: int) -> List[bytes]:
        return list(self.iter_fragments(n_ranks))

    def to_blob(self) -> StateBlob:
        """Materialize the contiguous blob (compat / small states)."""
        return StateBlob(data=b"".join(self.parts), manifest=self.manifest)


def serialize_state_stream(
    state: Any, step: int = 0, meta: Dict[str, Any] | None = None
) -> StateStream:
    """Flatten a state tree into a stream of buffers + manifest.

    CRC32/SHA256 are computed incrementally over the buffers, so the
    manifest is byte-identical to :func:`serialize_state`'s without ever
    joining the buffers.
    """
    leaves_with_paths, treedef = _flatten(state)
    entries: List[Dict[str, Any]] = []
    parts: List[bytes] = []
    offset = 0
    crc = 0
    sha = hashlib.sha256()
    for path, leaf in leaves_with_paths:
        raw, shape, dtype = _leaf_bytes(leaf)
        entries.append(
            {
                "name": _leaf_name(path),
                "shape": shape,
                "dtype": dtype,
                "offset": offset,
                "nbytes": len(raw),
            }
        )
        parts.append(raw)
        offset += len(raw)
        crc = zlib.crc32(raw, crc)
        sha.update(raw)
    manifest = {
        "version": 1,
        "step": int(step),
        "total_bytes": offset,
        "crc32": crc & 0xFFFFFFFF,
        "sha256": sha.hexdigest(),
        "treedef": f"PyTreeDef({treedef})",
        "leaves": entries,
        "meta": dict(meta or {}),
    }
    return StateStream(parts=parts, manifest=manifest)


def serialize_state(state: Any, step: int = 0, meta: Dict[str, Any] | None = None) -> StateBlob:
    """Flatten a state tree into a contiguous blob + manifest."""
    return serialize_state_stream(state, step=step, meta=meta).to_blob()


def deserialize_state(blob: StateBlob, like: Any) -> Any:
    """Rebuild the state tree using `like` (a tree with the same
    structure) as the structural template.  Dtypes/shapes come from the
    manifest and shapes are cross-checked against the template."""
    if (zlib.crc32(blob.data) & 0xFFFFFFFF) != blob.manifest["crc32"]:
        raise IOError("checkpoint blob failed CRC32 integrity check")
    leaves_with_paths, _ = _flatten(like)
    entries = blob.manifest["leaves"]
    if len(entries) != len(leaves_with_paths):
        raise ValueError(
            f"checkpoint has {len(entries)} leaves, template has {len(leaves_with_paths)}"
        )
    out: List[Any] = []
    for entry, (path, leaf) in zip(entries, leaves_with_paths):
        name = _leaf_name(path)
        if entry["name"] != name:
            raise ValueError(f"leaf order mismatch: {entry['name']} != {name}")
        raw = blob.data[entry["offset"] : entry["offset"] + entry["nbytes"]]
        arr = _leaf_from(raw, entry, leaf)
        if tuple(arr.shape) != _shape_of(leaf):
            raise ValueError(
                f"shape mismatch for {name}: checkpoint {tuple(arr.shape)} vs "
                f"template {_shape_of(leaf)}"
            )
        out.append(arr)
    return _unflatten(like, iter(out))


# ---------------------------------------------------------------------- #
# byte partitioning
# ---------------------------------------------------------------------- #


def fragment_key(tag: str, step: int, rank: int) -> str:
    return f"{tag}/step{step:08d}/frag{rank:05d}.bin"


def compute_fragment_size(total_bytes: int, n_ranks: int) -> int:
    """Equal fragment size: ceil-divided over ranks, rounded up to ALIGN.

    The single source of truth for fragment layout — shared by the
    streaming path (StateStream.iter_fragments) and the blob path
    (partition_blob) so the two can never desynchronize.
    """
    if n_ranks < 1:
        raise ValueError("n_ranks must be >= 1")
    frag = (total_bytes + n_ranks - 1) // n_ranks
    return (frag + ALIGN - 1) // ALIGN * ALIGN


def partition_blob(data: bytes, n_ranks: int) -> List[bytes]:
    """Split into `n_ranks` equal fragments, zero-padded to ALIGN bytes.

    All fragments have identical length (required for XOR groups); the
    manifest's total_bytes recovers the original length on join.
    """
    frag = compute_fragment_size(len(data), n_ranks)
    view = memoryview(data)
    out: List[bytes] = []
    for i in range(n_ranks):
        piece = bytes(view[i * frag : (i + 1) * frag])
        if len(piece) < frag:  # only tail fragments pay the pad copy
            piece += b"\x00" * (frag - len(piece))
        out.append(piece)
    return out


def join_fragments(fragments: Sequence[bytes], total_bytes: int) -> bytes:
    data = b"".join(fragments)
    if len(data) < total_bytes:
        raise ValueError(f"fragments cover {len(data)} bytes < expected {total_bytes}")
    return data[:total_bytes]
