"""``flash_attention_roofline.<cell kind>``: the least time of the
window's causal attentions (kept heads) over the device time of the
kernels named ``flash_kernel*`` in the trace, in %."""
from perfbench.lib.trace import kernel_seconds


def read(rec):
    least = rec.get("kernels_least_s", {}).get("flash_attention")
    spent = kernel_seconds(rec["trace"], "flash_kernel")
    if not least or not spent:
        return None
    return 100.0 * least / spent
