"""Levels of the builder's loop a build: ``build.level`` spans over
``build.forest`` spans, in the span traced with the host's ops (the
program's spans, ``repro_torch/tracing.py``)."""


def read(obs):
    if obs.kind != "build" or not obs.gaps:
        return None
    host = obs.gaps[2]
    builds = sum(op[0] == "build.forest" for op in host)
    levels = sum(op[0] == "build.level" for op in host)
    if not builds or not levels:
        return None
    return levels / builds
