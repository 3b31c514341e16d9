"""The work of one call of each kernel function: ``(flops, bytes)`` from
shapes and dtypes alone.

One declaration serves three readers: the dry run's counter
(:class:`repro_torch.launch.dryrun.CostCounter`), which adds a call's
work wherever the call runs (a CUDA kernel, which no operator-level
counter sees, or its shape rule on the meta device); and the bounds that
``chip_smoke.py`` prints, which divide these numbers by the card's peak
rates.  A call is the function a model calls, whatever number of CUDA
launches it takes.

The rule is the function's least work, not the kernel's traffic: each
input byte read once and each output byte written once, and 2 flops per
multiply-add the function needs.  What a kernel saves for its own
backward (flash's log-sum-exp is the function's output; the scans' chunk
states are not) and what it re-reads from its caches is not counted.
Attention counts the (query, key) pairs a row may see: every pair
without ``causal``; with it, each row's keys up to its diagonal or below
the prefix, whichever reaches further.

The paged functions read the rows their table names.  Which rows those
are, and how far each row's length reaches, are values: meta tensors
have none, and a CUDA wrapper does not read them back (a host sync on
every decode step).  So a call's reported work takes every table entry's
page as read and every position up to the table's end as attended: the
most the call may need.  A caller that knows the values passes ``rows``
(the unique pool rows: shared pages count once) and ``positions`` (the
query rows' clamped lengths, summed), as ``chip_smoke.py``'s bound does.

:data:`ACTIVE` is the counter a dry run installs; with none, a kernel
function pays one check of this module global (:func:`counted`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

# the active cost counter (a ``launch.dryrun.CostCounter`` while one is
# entered), or None
ACTIVE = None

Work = Tuple[int, int]

__all__ = ["ACTIVE", "counted", "flash_bwd", "flash_fwd", "mamba2_ssd_bwd",
           "mamba2_ssd_fwd", "paged", "visible_pairs", "wkv6_bwd", "wkv6_fwd",
           "xor_reduce"]


def counted(name: str, work: Callable[[], Work], fn: Callable, *args, **kw):
    """``fn(*args, **kw)``; under an active counter, inside its record of
    one call of kernel function ``name`` with the work ``work()`` returns
    (the operators ``fn`` runs are the kernel's, not counted again)."""
    if ACTIVE is None:
        return fn(*args, **kw)
    with ACTIVE.kernel(name, work()):
        return fn(*args, **kw)


def visible_pairs(tq: int, tk: int, causal: bool = True,
                  prefix_len: int = 0) -> int:
    """The (query, key) pairs one head attends: every pair without
    ``causal``; with it, row i (of Tq, the last row on the last key) sees
    keys up to ``i + Tk - Tq`` or below the prefix, whichever reaches
    further."""
    if not causal:
        return tq * tk
    off = tk - tq
    p = min(prefix_len, tk)
    if off < 0:       # more rows than keys: not a call the kernels take
        return sum(max(min(tk, i + 1 + off), p) for i in range(tq))
    # rows i < p - 1 - off see the prefix's p keys, the rest i + 1 + off
    n1 = max(0, min(tq, p - 1 - off))
    return n1 * p + (tq - n1) * (1 + off) + (n1 + tq - 1) * (tq - n1) // 2


def _flash_bytes(b, tq, tk, hq, hkv, d, dv, elem):
    return (b * tq * hq * d * elem, b * tk * hkv * d * elem,
            b * tq * hq * dv * elem, b * tk * hkv * dv * elem, b * hq * tq * 4)


def flash_fwd(b: int, tq: int, tk: int, hq: int, hkv: int, d: int, dv: int,
              elem: int, causal: bool = True, prefix_len: int = 0) -> Work:
    """Flash attention's forward: q, k, v read, o and the f32 log-sum-exp
    written; Q K^T over d and P V over dv for each visible pair."""
    pairs = visible_pairs(tq, tk, causal, prefix_len)
    q, k, o, v, lse = _flash_bytes(b, tq, tk, hq, hkv, d, dv, elem)
    return 2 * b * hq * pairs * (d + dv), q + k + v + o + lse


def flash_bwd(b: int, tq: int, tk: int, hq: int, hkv: int, d: int, dv: int,
              elem: int, causal: bool = True, prefix_len: int = 0) -> Work:
    """Its backward: q, k, v, o, dO and the log-sum-exp read, dq, dk, dv
    written; Q K^T, dS K and dS^T Q over d, dO V^T and P^T dO over dv."""
    pairs = visible_pairs(tq, tk, causal, prefix_len)
    q, k, o, v, lse = _flash_bytes(b, tq, tk, hq, hkv, d, dv, elem)
    return (2 * b * hq * pairs * (3 * d + 2 * dv),
            q + k + v + 2 * o + lse + q + k + v)


def paged(b: int, hq: int, hkv: int, d: int, q_elem: int, kv_elem: int,
          n_p: int, page: int, quant: bool = False, t: int = 1,
          rows: Optional[int] = None, positions: Optional[int] = None) -> Work:
    """Paged decode attention of ``t`` query rows per lane (B lanes, each
    over an (nP,) int32 table of ``page``-position pages) over a bf16 /
    f32 pool (``quant``: int8 with an f32 scale per row and kv head): q,
    table and int32 lengths read, the K and V rows read once each, the
    output written (q's dtype); 4 flops per (query head, position, dim).
    ``rows`` and ``positions`` default to the table's whole reach (see the
    module's docstring)."""
    rows = b * n_p * page if rows is None else rows
    positions = b * t * n_p * page if positions is None else positions
    per_row = hkv * d * kv_elem + (hkv * 4 if quant else 0)
    nbytes = (2 * rows * per_row + 2 * b * t * hq * d * q_elem
              + b * n_p * 4 + b * t * 4)
    return 4 * hq * d * positions, nbytes


def xor_reduce(r: int, m: int) -> Work:
    """XOR over R stacked (M, 128) int32 blocks: every word read once, the
    result written; R - 1 XORs per result word (integer operations)."""
    return (r - 1) * m * 128, (r + 1) * m * 128 * 4


def wkv6_fwd(b: int, t: int, h: int, d: int, elem: int,
             state: bool = False) -> Work:
    """WKV6 forward over (B, T, H, D): r, k, v in the inputs' dtype, w and
    u f32 read, y written and the f32 final state; with ``state`` the
    initial state read too; 5 flops per state element and token."""
    act = b * t * h * d
    s = b * h * d * d * 4
    nbytes = 3 * act * elem + act * 4 + h * d * 4 + act * elem + s
    return 5 * b * t * h * d * d, nbytes + (s if state else 0)


def wkv6_bwd(b: int, t: int, h: int, d: int, elem: int,
             dstate: bool = False, dstate0: bool = False) -> Work:
    """Its backward: the inputs and dy read, dr, dk, dv, dw, du written;
    with ``dstate`` the final state's gradient read, with ``dstate0`` the
    initial state's written; 14 flops per state element and token (the
    states, G, and the four gradient contractions)."""
    act = b * t * h * d
    s = b * h * d * d * 4
    nbytes = (3 * act * elem + act * 4 + h * d * 4 + act * elem
              + 3 * act * elem + act * 4 + h * d * 4)
    return (14 * b * t * h * d * d,
            nbytes + (s if dstate else 0) + (s if dstate0 else 0))


def mamba2_ssd_fwd(b: int, t: int, h: int, p: int, n: int, elem: int,
                   state: bool = False) -> Work:
    """SSD forward over x (B, T, H, P), dt (B, T, H) f32, A (H,) f32 and
    B, C (B, T, N): those read, y and the f32 final state (B, H, P, N)
    written; with ``state`` the initial state read too; 5 flops per state
    element and token."""
    act = b * t * h * p
    bc = 2 * b * t * n * elem
    s = b * h * p * n * 4
    nbytes = act * elem + b * t * h * 4 + h * 4 + bc + act * elem + s
    return 5 * b * t * h * p * n, nbytes + (s if state else 0)


def mamba2_ssd_bwd(b: int, t: int, h: int, p: int, n: int, elem: int,
                   dstate: bool = False, dstate0: bool = False) -> Work:
    """Its backward: the inputs and dy read, dx, ddt, dA, dB, dC written;
    ``dstate`` and ``dstate0`` as for :func:`wkv6_bwd`; 14 flops per state
    element and token."""
    act = b * t * h * p
    bc = 2 * b * t * n * elem
    s = b * h * p * n * 4
    nbytes = (act * elem + b * t * h * 4 + h * 4 + bc + act * elem
              + act * elem + b * t * h * 4 + h * 4 + bc)
    return (14 * b * t * h * p * n,
            nbytes + (s if dstate else 0) + (s if dstate0 else 0))
