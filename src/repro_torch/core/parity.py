"""XOR parity codes for checkpoint redundancy (DEEP-ER §III-D1).

Two schemes, matching the paper's two parity strategies:

* **Distributed XOR** (SCR-style, RAID-5 rotation): within a set of N
  ranks, each rank's fragment is split into N-1 pieces; rank *i* stores a
  parity block covering one distinct piece of every *other* rank (piece
  ``(i - j - 1) mod N`` of owner *j*).  Losing any single rank loses its
  fragment and its parity block — every piece of the lost fragment is
  still covered by a *surviving* holder, so reconstruction needs only
  survivors.  Storage overhead per rank: ``|F| / (N-1)``.

* **NAM XOR**: the plain group parity ``P = F_0 ^ ... ^ F_{N-1}`` computed
  and stored *off the failure domain* (on the NAM).  No rotation needed
  because the NAM does not die with a node.  ``F_k = P ^ XOR(F_j, j!=k)``.

Host paths use numpy (fragments are host bytes on the checkpoint path);
the device path (`xor_reduce`) dispatches by tensor device: the CUDA XOR
kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.xor_parity import LANES


# ---------------------------------------------------------------------- #
# host-side primitives
# ---------------------------------------------------------------------- #


def xor_bytes(fragments: Sequence[bytes]) -> bytes:
    """XOR of equally-sized byte strings."""
    if not fragments:
        raise ValueError("need at least one fragment")
    n = len(fragments[0])
    acc = np.frombuffer(fragments[0], dtype=np.uint8).copy()
    for f in fragments[1:]:
        if len(f) != n:
            raise ValueError(f"fragment size mismatch: {len(f)} != {n}")
        np.bitwise_xor(acc, np.frombuffer(f, dtype=np.uint8), out=acc)
    return acc.tobytes()


def _split_pieces(fragment: bytes, n_pieces: int) -> List[bytes]:
    """Split into n_pieces equal pieces (zero-padded)."""
    piece = (len(fragment) + n_pieces - 1) // n_pieces
    padded = fragment + b"\x00" * (piece * n_pieces - len(fragment))
    return [padded[i * piece : (i + 1) * piece] for i in range(n_pieces)]


def _piece_index(holder: int, owner: int, n: int) -> int:
    """Which piece of `owner` the parity block on `holder` covers."""
    assert holder != owner
    return (holder - owner - 1) % n  # in [0, n-2] for holder != owner


# ---------------------------------------------------------------------- #
# Distributed XOR (RAID-5 rotation)
# ---------------------------------------------------------------------- #


def encode_xor_group(fragments: Sequence[bytes]) -> List[bytes]:
    """Per-rank parity blocks for a group of N equally-sized fragments."""
    n = len(fragments)
    if n < 2:
        raise ValueError("XOR group needs >= 2 members")
    pieces = [_split_pieces(f, n - 1) for f in fragments]
    blocks: List[bytes] = []
    for holder in range(n):
        covered = [
            pieces[owner][_piece_index(holder, owner, n)]
            for owner in range(n)
            if owner != holder
        ]
        blocks.append(xor_bytes(covered))
    return blocks


def reconstruct_xor_group(
    failed: int,
    fragments: Dict[int, bytes],
    parity: Dict[int, bytes],
    n: int,
    fragment_bytes: int,
) -> bytes:
    """Rebuild fragment `failed` from surviving fragments + parity blocks.

    `fragments`/`parity` map group-local rank -> bytes for survivors.
    """
    if failed in fragments:
        return fragments[failed]
    missing = [i for i in range(n) if i != failed and i not in fragments]
    if missing:
        raise RuntimeError(f"cannot reconstruct: survivors {missing} also missing")
    piece_len = ((fragment_bytes + n - 2) // (n - 1))
    survivor_pieces = {i: _split_pieces(fragments[i], n - 1) for i in fragments}
    rebuilt: List[bytes] = []
    for m in range(n - 1):  # piece m of the failed rank
        holder = (failed + 1 + m) % n  # inverse of _piece_index
        assert holder != failed and _piece_index(holder, failed, n) == m
        if holder not in parity:
            raise RuntimeError(f"parity block on rank {holder} unavailable")
        terms = [parity[holder]]
        for owner in range(n):
            if owner in (holder, failed):
                continue
            terms.append(survivor_pieces[owner][_piece_index(holder, owner, n)])
        rebuilt.append(xor_bytes(terms)[:piece_len])
    return b"".join(rebuilt)[:fragment_bytes]


# ---------------------------------------------------------------------- #
# NAM XOR (plain group parity held off the failure domain)
# ---------------------------------------------------------------------- #


def encode_nam_parity(fragments: Sequence[bytes]) -> bytes:
    return xor_bytes(fragments)


def reconstruct_from_nam(
    failed: int, fragments: Dict[int, bytes], nam_parity: bytes, n: int
) -> bytes:
    survivors = [fragments[i] for i in range(n) if i != failed]
    if len(survivors) != n - 1:
        raise RuntimeError("cannot reconstruct: more than one group member lost")
    return xor_bytes([nam_parity] + survivors)


# ---------------------------------------------------------------------- #
# device path (CUDA kernel / plain PyTorch version, by tensor device)
# ---------------------------------------------------------------------- #


def pack_words(fragments: Sequence[bytes], device="cuda") -> torch.Tensor:
    """Stack byte fragments into the (R, M, 128) int32 kernel layout."""
    n = len(fragments[0])
    words = (n + 3) // 4
    rows = (words + LANES - 1) // LANES
    arrs = []
    for f in fragments:
        a = np.frombuffer(f + b"\x00" * (rows * LANES * 4 - len(f)), dtype=np.int32)
        arrs.append(a.reshape(rows, LANES))
    return torch.from_numpy(np.stack(arrs)).to(device)


def unpack_words(arr: torch.Tensor, nbytes: int) -> bytes:
    return arr.detach().cpu().numpy().tobytes()[:nbytes]


def xor_reduce(stacked: torch.Tensor, use_kernel: bool | None = None) -> torch.Tensor:
    """Device XOR-reduce over axis 0: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor (see :mod:`repro_torch.kernels.ops`)."""
    return ops.xor_reduce(stacked, use_kernel=use_kernel)
