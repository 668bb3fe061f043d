"""The device's idle share of the traced sub-window: 1 - the union of
the device operations' intervals (kernels, copies, sets) over the
window's length, so overlapping operations count once."""


def read(run):
    tr = run.record.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
