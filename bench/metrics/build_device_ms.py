"""Device busy ms a build (the union of the device operations' intervals
in the traced rebuild window, over its builds)."""


def read(obs):
    if obs.kind != "build" or not obs.units or not obs.device_ops:
        return None
    return obs.busy_us() / obs.units / 1e3
