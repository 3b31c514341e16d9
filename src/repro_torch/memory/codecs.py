"""Tier codecs and the shared int8 quantization math, in torch.

Counterpart of ``repro/memory/codecs.py``:

* :func:`int8_quantize` / :func:`int8_dequantize` and
  :data:`SCALE_SUFFIX`: the quantized page pool and the quantized
  paged-attention path call these two functions, so the int8 values and
  scales are bit-equal to the reference's (same ``EPS``, float32
  division, round-half-to-even, clip to +-127);
* the byte-blob codecs :class:`ZlibCodec` and :class:`Int8Codec` behind
  one self-describing frame (magic + codec id + original length), with
  :func:`is_encoded`, :func:`decode_blob` and :class:`CodecRule` for the
  tier stack.  The frames are byte-identical to the reference's: the
  int8 frame quantizes with the same math above, and bfloat16 blobs are
  read and written as raw 16-bit patterns (no ml_dtypes needed).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import torch

EPS = 1e-12  # zero-page guard; matches the reference

# companion-buffer naming for quantized device pools: leaf "k" holds int8
# values, "k__scale" the per-channel float32 scales
SCALE_SUFFIX = "__scale"

# frame: MAGIC (6) | codec id (2) | original length u64 LE | codec payload
_MAGIC = b"\xc5\x0d\xec\x17\x9a\x3b"
_HEADER = struct.Struct("<6s2sQ")


# ---------------------------------------------------------------------- #
# the shared int8 quantization math
# ---------------------------------------------------------------------- #


def int8_quantize(x: torch.Tensor, axis: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization: ``q = round(x / scale)`` with
    ``scale = max(|x|) / 127`` over the whole tensor (``axis=None``) or
    per channel along ``axis`` (keepdims).  Returns ``(q int8, scale
    f32)``."""
    xf = x.to(torch.float32)
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=EPS) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`int8_quantize` (float32 result)."""
    return q.to(torch.float32) * scale


# ---------------------------------------------------------------------- #
# byte-blob codecs
# ---------------------------------------------------------------------- #

# the float dtypes an int8 frame may hold, by the name its header carries
_FLOAT_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                 "float32": torch.float32, "float64": torch.float64}


def _float_dtype(name: str) -> torch.dtype:
    dt = _FLOAT_DTYPES.get(str(name))
    if dt is None:
        raise ValueError(f"Int8Codec needs a float dtype, got {name}")
    return dt


def _tensor_bytes(x: torch.Tensor) -> bytes:
    """Raw little-endian bytes of a CPU tensor (bfloat16 as its bits)."""
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy().tobytes()


@runtime_checkable
class Codec(Protocol):
    """One tier codec: framed bytes in, framed bytes out."""

    cid: bytes        # 2-byte frame id
    lossless: bool

    def encode(self, data: bytes) -> bytes: ...
    def decode(self, blob: bytes) -> bytes: ...


def is_encoded(data: bytes) -> bool:
    """True when ``data`` is a framed codec blob (magic + known id)."""
    return (len(data) >= _HEADER.size and data[:6] == _MAGIC
            and data[6:8] in _CODECS)


def decode_blob(data: bytes) -> bytes:
    """Decode any framed blob, self-describing (the frame header carries
    the codec id and its parameters)."""
    if len(data) < _HEADER.size or data[:6] != _MAGIC:
        raise ValueError("not a framed codec blob")
    cid = data[6:8]
    codec = _CODECS.get(cid)
    if codec is None:
        raise ValueError(f"unknown codec id {cid!r}")
    return codec.decode(data)


def maybe_decode(data: bytes) -> bytes:
    """Decode if framed, pass plaintext through unchanged."""
    return decode_blob(data) if is_encoded(data) else data


def _frame(cid: bytes, orig_len: int, payload: bytes) -> bytes:
    return _HEADER.pack(_MAGIC, cid, orig_len) + payload


def _unframe(cid: bytes, blob: bytes) -> Tuple[int, bytes]:
    magic, got, orig_len = _HEADER.unpack_from(blob)
    if magic != _MAGIC or got != cid:
        raise ValueError(f"blob is not a {cid!r} frame")
    return orig_len, blob[_HEADER.size:]


class ZlibCodec:
    """Lossless DEFLATE of the raw bytes — the policy for classes that
    must stay bit-identical (checkpoint fragments, descriptors)."""

    cid = b"zl"
    lossless = True

    def __init__(self, level: int = 1):
        self.level = int(level)

    def encode(self, data: bytes) -> bytes:
        if is_encoded(data):
            return data
        return _frame(self.cid, len(data), zlib.compress(data, self.level))

    def decode(self, blob: bytes) -> bytes:
        orig_len, payload = _unframe(self.cid, blob)
        out = zlib.decompress(payload)
        if len(out) != orig_len:
            raise ValueError(
                f"zlib frame decoded to {len(out)} bytes, expected {orig_len}")
        return out


# int8 frame payload: dtype name (16 bytes, NUL-padded) | block u32 |
# q int8[nblocks*block] | scales f32[nblocks] | raw tail (len % itemsize)
_I8_HEAD = struct.Struct("<16sI")


class Int8Codec:
    """Symmetric per-channel int8 over a byte blob viewed as a flat array
    of ``dtype``: one float32 scale per ``block`` consecutive elements,
    bytes past the last whole element carried raw.  Lossy: decode returns
    ``q * scale`` cast back to ``dtype``."""

    cid = b"i8"
    lossless = False

    def __init__(self, dtype: str = "float32", block: int = 128):
        if block < 1:
            raise ValueError("block must be >= 1")
        self.dtype_name = str(dtype)
        self.dtype = _float_dtype(self.dtype_name)
        self.block = int(block)

    def encode(self, data: bytes) -> bytes:
        if is_encoded(data):
            return data
        isz = self.dtype.itemsize
        n = len(data) // isz
        body, tail = data[:n * isz], data[n * isz:]
        nblocks = -(-n // self.block) if n else 0
        if n:
            x = torch.frombuffer(bytearray(body), dtype=self.dtype).float()
            if nblocks * self.block != n:       # pad the ragged last block
                x = torch.cat([x, torch.zeros(nblocks * self.block - n)])
            q, scale = int8_quantize(x.reshape(nblocks, self.block), axis=-1)
            payload = _tensor_bytes(q) + _tensor_bytes(scale)
        else:
            payload = b""
        head = _I8_HEAD.pack(self.dtype_name.encode()[:16], self.block)
        return _frame(self.cid, len(data), head + payload + tail)

    def decode(self, blob: bytes) -> bytes:
        orig_len, payload = _unframe(self.cid, blob)
        dt_raw, block = _I8_HEAD.unpack_from(payload)
        dtype = _float_dtype(dt_raw.rstrip(b"\x00").decode())
        body = payload[_I8_HEAD.size:]
        isz = dtype.itemsize
        n = orig_len // isz
        tail_len = orig_len - n * isz
        nblocks = -(-n // block) if n else 0
        q_len, s_len = nblocks * block, nblocks * 4
        if len(body) != q_len + s_len + tail_len:
            raise ValueError(
                f"int8 frame payload of {len(body)} bytes inconsistent with "
                f"header (expected {q_len + s_len + tail_len})")
        if n:
            q = torch.frombuffer(bytearray(body[:q_len]), dtype=torch.int8)
            scale = torch.frombuffer(bytearray(body[q_len:q_len + s_len]),
                                     dtype=torch.float32)
            x = int8_dequantize(q.reshape(nblocks, block),
                                scale.reshape(nblocks, 1)).reshape(-1)[:n]
            out = _tensor_bytes(x.to(dtype))
        else:
            out = b""
        return out + body[q_len + s_len:]


# decode registry: one canonical instance per codec id (Int8Codec.decode
# reads its parameters from the frame, so any instance decodes any frame)
_CODECS: Dict[bytes, Codec] = {
    ZlibCodec.cid: ZlibCodec(),
    Int8Codec.cid: Int8Codec(),
}


# ---------------------------------------------------------------------- #
# stack policy
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class CodecRule:
    """One key class's codec policy on a TierStack: values encode when
    they land on level index >= ``fast_levels`` and decode on every read
    — the ``fast_levels`` fastest levels always hold plaintext."""

    codec: Codec
    fast_levels: int = 1

    def __post_init__(self):
        if self.fast_levels < 0:
            raise ValueError("fast_levels must be >= 0")


def make_codec(name: Optional[str], dtype: str = "float32",
               block: int = 128) -> Optional[Codec]:
    """Resolve a codec knob string: ``None`` / ``"none"`` -> no codec,
    ``"zlib"`` -> lossless, ``"int8"`` -> per-channel quantization of
    blobs holding ``dtype`` elements."""
    if name is None or name == "none":
        return None
    if name == "zlib":
        return ZlibCodec()
    if name == "int8":
        return Int8Codec(dtype=dtype, block=block)
    raise ValueError(f"unknown codec {name!r} (want none|zlib|int8)")
