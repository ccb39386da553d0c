"""The whole search step's least time over the traced window's wall time,
in percent: the rerank's ops and bytes plus the forest's nodes and leaves
read once (``bench/workcount.py``), summed over the window's batches.  It
bounds a gain whatever kernels implement the step."""


def read(obs):
    least = obs.work.get("step_least_s")
    if (obs.kind != "search" or not least or not obs.device_ops
            or obs.window_us <= 0):
        return None
    return 100.0 * least / (obs.window_us / 1e6)
