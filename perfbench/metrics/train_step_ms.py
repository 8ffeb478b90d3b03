"""``train_step_ms.<cell kind>``: the median train step of the window, host
clock, each step ending in a synchronize, in ms."""


def read(rec):
    return rec.get("train_step_ms")
