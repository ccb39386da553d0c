"""Share of the traced search window in which no device operation ran (the
union of their intervals), in percent."""


def read(obs):
    if obs.kind != "search" or not obs.device_ops or obs.window_us <= 0:
        return None
    return 100.0 * (1.0 - obs.busy_us() / obs.window_us)
