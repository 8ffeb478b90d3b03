"""``mfu.<cell kind>``: the least time of the math the traced window
completed (its operations over the peak of each operation's dtype; kept
units only) over the traced window, in %."""


def read(rec):
    if not rec.get("peak_s"):
        return None
    return 100.0 * rec["peak_s"] / rec["trace"]["window_s"]
