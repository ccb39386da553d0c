"""Device ms a batch in kernels whose name holds ``forest_traverse``
(kernel A, the descent)."""


def read(obs):
    us = obs.kernel_us("forest_traverse")
    if obs.kind != "search" or not obs.units or not us:
        return None
    return us / obs.units / 1e3
