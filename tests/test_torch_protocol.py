"""The port's wire protocol against the reference's: every control frame
(HELLO with and without the caps byte, RESPLIT, heartbeat, DRAIN, BUSY),
the sealed envelope, ``frame_lane`` and the stream framing, each encoded
by both packages to the same bytes and decoded by each from the other's
bytes to the same values."""
from __future__ import annotations

import io

import numpy as np
import pytest

from repro.core.collab import protocol as rp
from repro_torch.core.collab import protocol as tp

_X = np.random.default_rng(3).standard_normal((1, 3, 3, 4)).astype(
    np.float32)
_KEEP = np.array([0, 2, 3])
CONTROL = ("hello", "resplit", "heartbeat", "drain", "busy", "sealed")


def _stream(m):
    fp = io.BytesIO()
    m.write_tensor(fp, _X)
    return fp.getvalue()


def _read(m, b):
    return m.read_tensor(io.BytesIO(b))


# name -> (build(module) -> bytes, decode(module, bytes) -> value, the
# control kind whose ``is_*`` predicate must hold, or None)
CASES = {
    "hello": (lambda m: m.encode_hello("0123abcd"),
              lambda m, b: (m.decode_hello(b), m.hello_caps(b)), "hello"),
    "hello_caps_crc": (lambda m: m.encode_hello("0123abcd", caps=m.CAP_CRC),
                       lambda m, b: (m.decode_hello(b), m.hello_caps(b)),
                       "hello"),
    "hello_reject_empty": (lambda m: m.encode_hello("", status=1),
                           lambda m, b: (m.decode_hello(b), m.hello_caps(b)),
                           "hello"),
    "resplit": (lambda m: m.encode_resplit(7),
                lambda m, b: m.decode_resplit(b), "resplit"),
    "resplit_reject": (lambda m: m.encode_resplit(65535, status=1),
                       lambda m, b: m.decode_resplit(b), "resplit"),
    "heartbeat": (lambda m: m.encode_heartbeat(),
                  lambda m, b: m.decode_heartbeat(b), "heartbeat"),
    "drain": (lambda m: m.encode_drain(),
              lambda m, b: m.decode_drain(b), "drain"),
    "busy_redirect": (lambda m: m.encode_busy("queue"),
                      lambda m, b: m.decode_busy(b), "busy"),
    "busy_stay": (lambda m: m.encode_busy("queue", redirect=False),
                  lambda m, b: m.decode_busy(b), "busy"),
    "sealed_tensor": (lambda m: m.encode_sealed(0xFFFFFFFF,
                                                m.encode_tensor(_X)),
                      lambda m, b: m.decode_sealed(b), "sealed"),
    "lane_raw": (lambda m: m.encode_tensor(_X),
                 lambda m, b: m.frame_lane(b), None),
    "lane_fp16": (lambda m: m.encode_feature(_X, codec="fp16"),
                  lambda m, b: m.frame_lane(b), None),
    "lane_int8_packed": (lambda m: m.encode_feature(_X, codec="int8",
                                                    keep=_KEEP),
                         lambda m, b: m.frame_lane(b), None),
    "lane_sealed_int8": (lambda m: m.encode_sealed(
                             9, m.encode_feature(_X, codec="int8")),
                         lambda m, b: m.frame_lane(b), "sealed"),
    "stream_tensor": (_stream, _read, None),
}


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_bytes_and_decodes_equal_the_reference(case):
    build, decode, kind = CASES[case]
    rb, tb = build(rp), build(tp)
    assert rb == tb
    assert _same(decode(tp, rb), decode(rp, rb))
    assert _same(decode(rp, tb), decode(tp, tb))
    for other in CONTROL:
        for m in (rp, tp):
            assert getattr(m, f"is_{other}")(tb) == (other == kind), other
