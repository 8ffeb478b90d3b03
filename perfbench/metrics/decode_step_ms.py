"""``decode_step_ms.<cell kind>``: the median interval between the ends of
consecutive decode steps on the device (CUDA events), in ms."""


def read(rec):
    return rec.get("decode_step_ms")
