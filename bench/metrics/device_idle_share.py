"""device_idle_share: the share of the traced part of the window in which
no kernel, copy or memset ran on the device, in %.  Device trace."""


def read(w):
    t = w.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
