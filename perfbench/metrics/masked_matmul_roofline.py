"""``masked_matmul_roofline.<cell kind>``: the least time of the window's
masked-GEMM calls (``counts``: kept columns, each operand once) over the
device time of the kernels named ``masked_matmul*`` in the trace, in %."""
from perfbench.lib.trace import kernel_seconds


def read(rec):
    least = rec.get("kernels_least_s", {}).get("masked_matmul")
    spent = kernel_seconds(rec["trace"], "masked_matmul")
    if not least or not spent:
        return None
    return 100.0 * least / spent
