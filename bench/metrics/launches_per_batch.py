"""Device kernels a search, counted in the traced window's profile."""


def read(obs):
    if obs.kind != "search" or not obs.units or not obs.kernels:
        return None
    return len(obs.kernels) / obs.units
