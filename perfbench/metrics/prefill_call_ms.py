"""``prefill_call_ms.<cell kind>``: the median prefill call of the window,
from the harness's call to the first token on the host after a
synchronize, in ms."""


def read(rec):
    return rec.get("prefill_call_ms")
