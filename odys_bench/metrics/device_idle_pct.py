"""``device_idle_pct``: the share of the profiled window in which no
kernel, memcpy or memset ran on the card (%)."""


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
