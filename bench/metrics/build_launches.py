"""Device kernels a build, counted in the traced rebuild window."""


def read(obs):
    if obs.kind != "build" or not obs.units or not obs.kernels:
        return None
    return len(obs.kernels) / obs.units
