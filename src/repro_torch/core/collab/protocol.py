"""The edge<->cloud wire codec, copied from the JAX package's
``repro.core.collab.protocol`` so that the two packages put byte-identical
frames on the wire (the ``tests/test_torch_*`` parity tests hold them to
it). This slice carries the tensor and feature frames and the sealed
envelope that ``decode_any`` unwraps; the socket backend's control frames
(HELLO, RESPLIT, heartbeat, DRAIN, BUSY) come with the socket slice.

Raw frame layout (``encode_tensor``):
    magic  u32  = 0x52455052 ("REPR")
    ndim   u32
    dtype  16s  (numpy dtype str, ascii, NUL-padded)
    shape  ndim * u64
    nbytes u64
    payload

Feature-codec frame layout (``encode_feature``), negotiated *per frame* by
the leading magic word:
    magic  u32  = 0x46504552 ("REPF")
    codec  u8   (0 = fp32, 1 = fp16, 2 = int8 scale+zero-point)
    packed u8   (1 => only surviving channels of the last axis are shipped)
    ndim   u16  (of the LOGICAL full shape)
    shape  ndim * u64
    [packed]  keep bitmask over the last axis, ceil(shape[-1] / 8) bytes
    [int8]    scale f32, zero f32                  (x ~= q * scale + zero)
    nbytes u64
    payload

``decode_feature`` always reconstructs a float32 tensor at the logical full
shape, with zeros in the pruned (non-kept) channel slots — exactly what
masked execution produces.

SEALED frame (``encode_sealed``) — integrity envelope around a data frame:
    magic   u32  = 0x46514553 ("SEQF")
    seq     u32  (request sequence number, wraps at 2**32)
    crc     u32  (CRC32 of the inner frame bytes)
    inner   the wrapped data frame (REPR / REPF)
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

MAGIC = 0x52455052
FEATURE_MAGIC = 0x46504552
SEALED_MAGIC = 0x46514553
_HDR = struct.Struct("<II16s")
_FHDR = struct.Struct("<IBBH")
_SEALED = struct.Struct("<III")


class FrameIntegrityError(ConnectionError):
    """A sealed frame failed its CRC32 check — the payload was corrupted
    or truncated in flight."""


CODEC_IDS = {"fp32": 0, "fp16": 1, "int8": 2}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}
#: wire bytes per element relative to raw fp32 — feeds the latency model's
#: T_TX pricing (see ``split_latency(tx_scale=...)``)
CODEC_TX_SCALE = {"fp32": 1.0, "fp16": 0.5, "int8": 0.25}
_CODEC_DTYPE = {"fp32": np.float32, "fp16": np.float16, "int8": np.uint8}


def encode_tensor(arr: np.ndarray) -> bytes:
    """Encode an ndarray as one self-describing raw tensor frame
    (``REPR`` magic + dtype + shape + payload). The returned length in
    bytes is what the runtimes report as ``tx_bytes`` when no feature
    codec is armed; the socket path's 8-byte length prefix is transport
    framing on top of this and is excluded from accounting."""
    arr = np.ascontiguousarray(arr)
    dt = arr.dtype.str.encode().ljust(16, b"\0")
    hdr = _HDR.pack(MAGIC, arr.ndim, dt)
    shape = struct.pack(f"<{arr.ndim}Q", *arr.shape)
    nbytes = struct.pack("<Q", arr.nbytes)
    return hdr + shape + nbytes + arr.tobytes()


def decode_tensor(buf: bytes) -> Tuple[np.ndarray, int]:
    """Decode one raw tensor frame -> (array, bytes consumed). The
    array is a zero-copy read-only view into ``buf``."""
    magic, ndim, dt = _HDR.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError("bad frame magic")
    off = _HDR.size
    shape = struct.unpack_from(f"<{ndim}Q", buf, off)
    off += 8 * ndim
    (nbytes,) = struct.unpack_from("<Q", buf, off)
    off += 8
    dtype = np.dtype(dt.rstrip(b"\0").decode())
    arr = np.frombuffer(buf, dtype, count=nbytes // dtype.itemsize,
                        offset=off).reshape(shape)
    return arr, off + nbytes


# ---------------------------------------------------------------------------
# feature codec (fp16 / int8 quantization + mask-aware channel packing)
# ---------------------------------------------------------------------------
def affine_qparams(mn: float, mx: float, levels: int) -> Tuple[float, float]:
    """Affine (scale, zero) mapping [mn, mx] onto the code points
    {0..levels}: dequant(q) = q * scale + zero. A degenerate range
    (mx == mn) gets scale 1.0 so round-tripping stays exact."""
    scale = (mx - mn) / float(levels) or 1.0
    return scale, mn


def affine_quantize(x: np.ndarray,
                    levels: int = 255) -> Tuple[np.ndarray, float, float]:
    """Min/max affine quantization onto uint8 code points {0..levels}
    -> (codes, scale, zero), with max-abs-error <= scale/2. This is the
    wire codec's int8 math (levels=255); the quantized edge path reuses
    it per weight channel (and with levels=15 for int4)."""
    mn = float(x.min()) if x.size else 0.0
    mx = float(x.max()) if x.size else 0.0
    scale, zero = affine_qparams(mn, mx, levels)
    q = np.clip(np.rint((x - zero) / scale), 0, levels).astype(np.uint8)
    return q, scale, zero


def encode_feature(arr: np.ndarray, codec: str = "fp32",
                   keep: Optional[np.ndarray] = None) -> bytes:
    """Encode an intermediate-feature tensor for the wire.

    ``keep`` — optional surviving-unit indices along the LAST axis (from
    ``repro_torch.models.cnn.split_keep_indices``): only those slices are
    shipped; the decoder zero-fills the rest. ``codec`` picks the payload
    precision; int8 uses per-frame affine quantization (max-abs-error
    <= scale/2 where scale = (max-min)/255).
    """
    if codec not in CODEC_IDS:
        raise ValueError(f"unknown codec {codec!r} (use {list(CODEC_IDS)})")
    full_shape = arr.shape
    x = np.ascontiguousarray(arr, dtype=np.float32)
    packed = keep is not None
    if packed:
        keep = np.asarray(keep, np.int64)
        x = np.ascontiguousarray(x[..., keep])
    extra = b""
    if codec == "fp16":
        payload_arr = x.astype(np.float16)
    elif codec == "int8":
        payload_arr, scale, zero = affine_quantize(x, levels=255)
        extra = struct.pack("<ff", scale, zero)
    else:
        payload_arr = x
    payload = payload_arr.tobytes()
    hdr = _FHDR.pack(FEATURE_MAGIC, CODEC_IDS[codec], int(packed),
                     len(full_shape))
    shape = struct.pack(f"<{len(full_shape)}Q", *full_shape)
    pack_hdr = b""
    if packed:
        bits = np.zeros(full_shape[-1], np.uint8)
        bits[keep] = 1
        pack_hdr = np.packbits(bits).tobytes()
    return (hdr + shape + pack_hdr + extra
            + struct.pack("<Q", len(payload)) + payload)


def decode_feature(buf: bytes) -> Tuple[np.ndarray, int]:
    """Decode an ``encode_feature`` frame -> (float32 tensor, consumed).

    Pruned channels that were packed away come back as zeros, matching
    masked execution on the receiving submodel.
    """
    magic, codec_id, packed, ndim = _FHDR.unpack_from(buf, 0)
    if magic != FEATURE_MAGIC:
        raise ValueError("bad feature-frame magic")
    codec = CODEC_NAMES[codec_id]
    off = _FHDR.size
    full_shape = struct.unpack_from(f"<{ndim}Q", buf, off)
    off += 8 * ndim
    keep = None
    if packed:
        n_mask_bytes = (full_shape[-1] + 7) // 8
        bits = np.unpackbits(np.frombuffer(buf, np.uint8,
                                           count=n_mask_bytes, offset=off),
                             count=full_shape[-1])
        keep = np.nonzero(bits)[0]
        off += n_mask_bytes
    scale, zero = 1.0, 0.0
    if codec == "int8":
        scale, zero = struct.unpack_from("<ff", buf, off)
        off += 8
    (nbytes,) = struct.unpack_from("<Q", buf, off)
    off += 8
    dtype = np.dtype(_CODEC_DTYPE[codec])
    wire_shape = (full_shape[:-1] + (len(keep),)) if packed else full_shape
    raw = np.frombuffer(buf, dtype, count=nbytes // dtype.itemsize,
                        offset=off).reshape(wire_shape)
    if codec == "int8":
        x = raw.astype(np.float32) * scale + zero
    elif raw.dtype == np.float32:
        x = raw          # zero-copy (read-only view) on the fp32 hot path
    else:
        x = raw.astype(np.float32)
    if packed:
        out = np.zeros(full_shape, np.float32)
        out[..., np.asarray(keep, np.int64)] = x
        x = out
    return x, off + nbytes


# ---------------------------------------------------------------------------
# sealed frames (CRC32 + sequence number)
# ---------------------------------------------------------------------------
def encode_sealed(seq: int, inner: bytes) -> bytes:
    """Wrap a data frame in an integrity envelope: sequence number plus
    CRC32 of the inner bytes. The cloud echoes ``seq`` on its (sealed)
    response, letting a reconnecting edge replay an in-flight request
    and discard stale replies."""
    crc = zlib.crc32(inner) & 0xFFFFFFFF
    return _SEALED.pack(SEALED_MAGIC, seq & 0xFFFFFFFF, crc) + inner


def decode_sealed(buf: bytes) -> Tuple[int, bytes]:
    """Unwrap a sealed frame -> (seq, inner frame bytes).

    Raises ``FrameIntegrityError`` when the CRC32 does not match —
    corruption or truncation happened between the peers.
    """
    magic, seq, crc = _SEALED.unpack_from(buf, 0)
    if magic != SEALED_MAGIC:
        raise ValueError("bad sealed-frame magic")
    inner = bytes(buf[_SEALED.size:])
    if zlib.crc32(inner) & 0xFFFFFFFF != crc:
        raise FrameIntegrityError(
            f"sealed frame seq={seq} failed CRC32 check "
            f"({len(inner)} inner bytes)")
    return seq, inner


def is_sealed(buf: bytes) -> bool:
    """True when the frame's leading magic marks a sealed envelope."""
    return (len(buf) >= 4
            and struct.unpack_from("<I", buf, 0)[0] == SEALED_MAGIC)


def decode_any(buf: bytes) -> Tuple[np.ndarray, int]:
    """Dispatch on the frame magic: raw tensor frame or codec frame
    (sealed envelopes are unwrapped — and CRC-checked — first)."""
    if is_sealed(buf):
        _, buf = decode_sealed(buf)
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic == FEATURE_MAGIC:
        return decode_feature(buf)
    return decode_tensor(buf)
