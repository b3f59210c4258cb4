"""Device: share of the traced sub-window in which the card runs neither a
kernel nor a copy (the host-to-device expert copies are this system's main
device work), in %; the prompt-only cell."""


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
