"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W).

A frozen copy: the port keeps its own in ``roofline/hw.py``, which a
later change to the program may edit; the benchmark's stays as it is.
"""

#: operations per second by the dtype an operation computes in
FLOP_S = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "int8": 1979e12,
    "float8": 1979e12,
    "tfloat32": 495e12,
    "float32": 67e12,         # CUDA cores, TF32 off
}
#: HBM3 bytes per second
HBM_BYTES_S = 3.35e12


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take for ``flops`` operations in
    ``dtype`` that move ``nbytes`` through HBM: the larger bound."""
    return max(flops / FLOP_S[dtype], nbytes / HBM_BYTES_S)
