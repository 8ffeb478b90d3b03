"""The edge<->cloud wire protocol, copied from the JAX package's
``repro.core.collab.protocol`` so that the two packages put byte-identical
frames on the wire (the ``tests/test_torch_*`` parity tests hold them to
it): length-prefixed tensor framing, the feature codec and the control
frames of the socket deployment (paper §3.3: "intermediate features are
transmitted to the cloud server through the socket protocol").

Raw frame layout (``encode_tensor``):
    magic  u32  = 0x52455052 ("REPR")
    ndim   u32
    dtype  16s  (numpy dtype str, ascii, NUL-padded)
    shape  ndim * u64
    nbytes u64
    payload

Feature-codec frame layout (``encode_feature``), negotiated *per frame* by
the leading magic word — a decoder calls ``decode_any`` and dispatches on
it, so raw-fp32 and codec peers interoperate without a handshake:
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
masked execution produces — so a cloud submodel is agnostic to which codec
the edge picked for any given frame.

HELLO frame (``encode_hello``) — the deployment-contract handshake used by
``repro_torch.serving``: the edge sends its ``DeploymentPlan`` digest on
connect and the cloud answers with its own digest plus an accept/reject
status, so a split/compact/codec mismatch between peers fails fast with
``PlanMismatchError`` instead of decoding garbage tensors:
    magic   u32  = 0x4F4C4548 ("HELO")
    version u16  (protocol version)
    status  u8   (0 = ok, 1 = digest mismatch — reply only)
    dlen    u8
    digest  dlen bytes (ascii hex, possibly empty for legacy peers)

RESPLIT frame (``encode_resplit``) — the live split-switch announcement
used by the adaptive controller: mid-connection, the edge proposes a new
split point and the cloud answers with accept/reject, after which both
peers swap their jitted sub-models *without reconnecting* (the cloud's
``start_layer`` becomes the edge's ``stop_layer``). Versioned like HELLO:
    magic   u32  = 0x4C505352 ("RSPL")
    version u16  (protocol version)
    status  u8   (0 = ok, 1 = split rejected — reply only)
    split   u16  (the proposed / acknowledged split point)

SEALED frame (``encode_sealed``) — integrity envelope around any data
frame, negotiated via the HELLO capability byte (``CAP_CRC``): a sealed
frame carries a request sequence number (u32, wraps) and the CRC32 of
the inner frame, so truncation and in-flight corruption surface as a
typed ``FrameIntegrityError`` instead of silently-wrong tensors, and a
reconnecting edge can replay an in-flight request and match the reply
by sequence number. Control frames (HELLO/RESPLIT/heartbeat) are never
sealed:
    magic   u32  = 0x46514553 ("SEQF")
    seq     u32  (request sequence number, wraps at 2**32)
    crc     u32  (CRC32 of the inner frame bytes)
    inner   the wrapped data frame (REPR / REPF / ...)

HEARTBEAT frame (``encode_heartbeat``) — one-way keepalive from edge to
cloud (no reply); a cloud serving a plan with a ``FaultPolicy`` whose
``heartbeat_s`` is set reaps clients idle for several intervals:
    magic   u32  = 0x42545248 ("HRTB")
    version u16  (protocol version)

DRAIN frame (``encode_drain``) — cloud-to-edge announcement that the
server is draining for a rolling restart: it stops admitting new
requests, flushes its batching lanes, and expects connected edges to
migrate to another fleet member mid-session (zero failed requests).
Versioned like HELLO:
    magic   u32  = 0x4E415244 ("DRAN")
    version u16  (protocol version)
    reason  u8   (0 = restart; reserved for future drain causes)

BUSY frame (``encode_busy``) — cloud-to-edge overload backpressure
reply sent instead of queueing a request on a saturated (bounded)
batching lane. Carries a shed-reason code mirroring the fleet
simulator's admission vocabulary and a redirect hint telling a
fleet-routed edge to retry the request on another healthy server:
    magic    u32  = 0x59535542 ("BUSY")
    version  u16  (protocol version)
    reason   u8   (shed reason code, 0 = "queue")
    redirect u8   (1 => retry on another fleet server)
"""
from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Dict, Optional, Tuple

import numpy as np

MAGIC = 0x52455052
FEATURE_MAGIC = 0x46504552
HELLO_MAGIC = 0x4F4C4548
RESPLIT_MAGIC = 0x4C505352
SEALED_MAGIC = 0x46514553
HEARTBEAT_MAGIC = 0x42545248
DRAIN_MAGIC = 0x4E415244
BUSY_MAGIC = 0x59535542
PROTOCOL_VERSION = 1
#: HELLO capability bit: peer understands sealed (CRC32 + seq) frames
CAP_CRC = 1
_HDR = struct.Struct("<II16s")
_FHDR = struct.Struct("<IBBH")
_HELLO = struct.Struct("<IHBB")
_RESPLIT = struct.Struct("<IHBH")
_SEALED = struct.Struct("<III")
_HEARTBEAT = struct.Struct("<IH")
_DRAIN = struct.Struct("<IHB")
_BUSY = struct.Struct("<IHBB")

#: BUSY shed-reason codes — the wire mirror of the fleet simulator's
#: admission vocabulary (``RequestRecord.shed_reason``); today only the
#: bounded-lane overflow reason exists on the socket path
BUSY_REASONS = {"queue": 0}
BUSY_REASON_NAMES = {v: k for k, v in BUSY_REASONS.items()}


class PlanMismatchError(ConnectionError):
    """The two peers of a split deployment disagree on the deployment
    contract (plan digest): split point, compaction, codec, or model shape.
    Raised by the HELLO handshake instead of letting the peers exchange
    undecodable / silently-wrong feature tensors."""


class FrameIntegrityError(ConnectionError):
    """A sealed frame failed its CRC32 check — the payload was corrupted
    or truncated in flight. Raised by ``decode_sealed`` instead of
    letting a flipped byte decode into silently-wrong tensors; the
    receiving peer treats the connection as compromised and the edge
    client retries the request on a fresh connection."""

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
# HELLO handshake (deployment-contract digest exchange)
# ---------------------------------------------------------------------------
def encode_hello(digest: str, status: int = 0,
                 version: int = PROTOCOL_VERSION, caps: int = 0) -> bytes:
    """Handshake frame carrying a plan digest (ascii hex, <= 255 chars).

    ``caps`` is an optional capability bitmask (``CAP_CRC`` => the peer
    speaks sealed CRC32+seq frames), appended as a single trailing byte
    only when non-zero. Legacy decoders slice the digest by ``dlen`` and
    ignore trailing bytes, so a caps-bearing HELLO is fully backward
    compatible — a legacy peer simply reads it as caps=0.
    """
    d = digest.encode("ascii")
    if len(d) > 255:
        raise ValueError("digest too long for HELLO frame")
    if not 0 <= caps <= 0xFF:
        raise ValueError("caps must fit one byte")
    tail = struct.pack("<B", caps) if caps else b""
    return _HELLO.pack(HELLO_MAGIC, version, status, len(d)) + d + tail


def decode_hello(buf: bytes) -> Tuple[str, int, int]:
    """Decode a HELLO frame -> (digest, status, version)."""
    magic, version, status, dlen = _HELLO.unpack_from(buf, 0)
    if magic != HELLO_MAGIC:
        raise ValueError("bad HELLO-frame magic")
    digest = buf[_HELLO.size:_HELLO.size + dlen].decode("ascii")
    return digest, status, version


def hello_caps(buf: bytes) -> int:
    """Capability bitmask of a HELLO frame; 0 for a legacy frame that
    carries no caps byte (pre-fault-tolerance peers)."""
    magic, _, _, dlen = _HELLO.unpack_from(buf, 0)
    if magic != HELLO_MAGIC:
        raise ValueError("bad HELLO-frame magic")
    off = _HELLO.size + dlen
    if len(buf) <= off:
        return 0
    return struct.unpack_from("<B", buf, off)[0]


def is_hello(buf: bytes) -> bool:
    """True when the frame's leading magic marks a HELLO handshake."""
    return (len(buf) >= 4
            and struct.unpack_from("<I", buf, 0)[0] == HELLO_MAGIC)


# ---------------------------------------------------------------------------
# RESPLIT control frame (live split-switch, no reconnect)
# ---------------------------------------------------------------------------
def encode_resplit(split: int, status: int = 0,
                   version: int = PROTOCOL_VERSION) -> bytes:
    """Control frame proposing (edge) or acknowledging (cloud) a new split
    point on the live connection."""
    if not 0 <= split <= 0xFFFF:
        raise ValueError(f"split {split} outside the u16 frame field")
    return _RESPLIT.pack(RESPLIT_MAGIC, version, status, split)


def decode_resplit(buf: bytes) -> Tuple[int, int, int]:
    """Decode a RESPLIT frame -> (split, status, version)."""
    magic, version, status, split = _RESPLIT.unpack_from(buf, 0)
    if magic != RESPLIT_MAGIC:
        raise ValueError("bad RESPLIT-frame magic")
    return split, status, version


def is_resplit(buf: bytes) -> bool:
    """True when the frame's leading magic marks a RESPLIT control frame."""
    return (len(buf) >= 4
            and struct.unpack_from("<I", buf, 0)[0] == RESPLIT_MAGIC)


# ---------------------------------------------------------------------------
# sealed frames (CRC32 + sequence number) and heartbeat keepalive
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


def encode_heartbeat(version: int = PROTOCOL_VERSION) -> bytes:
    """One-way keepalive frame (edge -> cloud, no reply expected)."""
    return _HEARTBEAT.pack(HEARTBEAT_MAGIC, version)


def is_heartbeat(buf: bytes) -> bool:
    """True when the frame's leading magic marks a heartbeat keepalive."""
    return (len(buf) >= 4
            and struct.unpack_from("<I", buf, 0)[0] == HEARTBEAT_MAGIC)


def decode_heartbeat(buf: bytes) -> int:
    """Decode a heartbeat keepalive -> the sender's protocol version
    (the pack twin of ``encode_heartbeat``; raises on a non-heartbeat
    frame)."""
    magic, version = _HEARTBEAT.unpack_from(buf, 0)
    if magic != HEARTBEAT_MAGIC:
        raise ValueError("bad heartbeat-frame magic")
    return version


# ---------------------------------------------------------------------------
# DRAIN / BUSY control frames (fleet drain-migration and backpressure)
# ---------------------------------------------------------------------------
def encode_drain(reason: int = 0,
                 version: int = PROTOCOL_VERSION) -> bytes:
    """Control frame announcing the server is draining (rolling restart):
    it admits no new requests, flushes its lanes, and connected edges
    should migrate to another healthy fleet server mid-session."""
    if not 0 <= reason <= 0xFF:
        raise ValueError("drain reason must fit one byte")
    return _DRAIN.pack(DRAIN_MAGIC, version, reason)


def decode_drain(buf: bytes) -> Tuple[int, int]:
    """Decode a DRAIN frame -> (reason, version). A frame that is too
    short or carries the wrong magic raises ``ValueError`` (the bad-frame
    vocabulary every peer already classifies), never ``struct.error``."""
    if len(buf) < _DRAIN.size or not is_drain(buf):
        raise ValueError("bad DRAIN-frame magic")
    _, version, reason = _DRAIN.unpack_from(buf, 0)
    return reason, version


def is_drain(buf: bytes) -> bool:
    """True when the frame's leading magic marks a DRAIN control frame."""
    return (len(buf) >= 4
            and struct.unpack_from("<I", buf, 0)[0] == DRAIN_MAGIC)


def encode_busy(reason: str = "queue", redirect: bool = True,
                version: int = PROTOCOL_VERSION) -> bytes:
    """Overload-backpressure reply sent instead of queueing a request on
    a saturated bounded lane. ``reason`` is a fleet-simulator shed
    reason (``BUSY_REASONS``); ``redirect`` hints that a fleet-routed
    edge should replay the request on another healthy server."""
    if reason not in BUSY_REASONS:
        raise ValueError(
            f"unknown BUSY reason {reason!r} (use {list(BUSY_REASONS)})")
    return _BUSY.pack(BUSY_MAGIC, version, BUSY_REASONS[reason],
                      int(bool(redirect)))


def decode_busy(buf: bytes) -> Tuple[str, bool, int]:
    """Decode a BUSY frame -> (shed reason name, redirect hint, version).
    Too-short / wrong-magic frames raise ``ValueError`` (never
    ``struct.error``), and an unknown shed-reason id from a newer peer
    raises ``ValueError`` too, so the edge's recovery loop classifies it
    as a bad frame instead of crashing on a ``KeyError``."""
    if len(buf) < _BUSY.size or not is_busy(buf):
        raise ValueError("bad BUSY-frame magic")
    _, version, reason_id, redirect = _BUSY.unpack_from(buf, 0)
    if reason_id not in BUSY_REASON_NAMES:
        raise ValueError(f"unknown BUSY shed-reason id {reason_id}")
    return BUSY_REASON_NAMES[reason_id], bool(redirect), version


def is_busy(buf: bytes) -> bool:
    """True when the frame's leading magic marks a BUSY backpressure
    reply."""
    return (len(buf) >= 4
            and struct.unpack_from("<I", buf, 0)[0] == BUSY_MAGIC)


def decode_any(buf: bytes) -> Tuple[np.ndarray, int]:
    """Dispatch on the frame magic: raw tensor frame or codec frame
    (sealed envelopes are unwrapped — and CRC-checked — first)."""
    if is_sealed(buf):
        _, buf = decode_sealed(buf)
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic == FEATURE_MAGIC:
        return decode_feature(buf)
    return decode_tensor(buf)


def frame_lane(buf: bytes) -> str:
    """Wire-encoding lane tag of a tensor/feature frame, without decoding
    the payload: ``"raw"`` for a plain tensor frame, else the codec name
    with ``"+packed"`` appended when channel packing is on. The dynamic
    batching engine keys its per-lane queues on this (frames that took
    different wire paths are batched separately, so per-lane accounting
    stays attributable per encoding). Sealed envelopes are unwrapped
    first — the lane is a property of the inner data frame."""
    if is_sealed(buf):
        _, buf = decode_sealed(buf)
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic != FEATURE_MAGIC:
        return "raw"
    _, codec_id, packed, _ = _FHDR.unpack_from(buf, 0)
    return CODEC_NAMES[codec_id] + ("+packed" if packed else "")


def write_tensor(fp: BinaryIO, arr: np.ndarray) -> int:
    """Write one length-prefixed raw tensor frame to a binary stream;
    returns the total bytes written (payload + 8-byte prefix)."""
    data = encode_tensor(arr)
    fp.write(struct.pack("<Q", len(data)))
    fp.write(data)
    fp.flush()
    return len(data) + 8


def read_exact(fp: BinaryIO, n: int) -> bytes:
    """Read exactly ``n`` bytes from a binary stream (raises ``EOFError``
    if the peer closes early) — the stream twin of
    ``repro_torch.core.collab.channel.recv_exact``."""
    chunks = []
    got = 0
    while got < n:
        chunk = fp.read(n - got)
        if not chunk:
            raise EOFError("peer closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_tensor(fp: BinaryIO) -> np.ndarray:
    """Read one length-prefixed raw tensor frame from a binary stream."""
    (n,) = struct.unpack("<Q", read_exact(fp, 8))
    arr, _ = decode_tensor(read_exact(fp, n))
    return arr
