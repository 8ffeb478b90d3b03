"""``device_idle.<cell kind>``: the share of the traced window in which
no operation ran on the device, in %."""


def read(rec):
    tr = rec["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
