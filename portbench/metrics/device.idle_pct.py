"""device.idle_pct: the share of the traced window in which no kernel, copy
or fill ran on the card (one minus the union of their intervals over the
window).  Device trace."""


def read(w):
    t = w.trace
    if t is None or not t.window_s or not t.device_events:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
