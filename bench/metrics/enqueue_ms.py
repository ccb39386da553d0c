"""Host ms a batch from the call into ``Index.search`` to its return,
averaged over every batch of the timed window (host clock).  The pristine
path makes no host sync, so this is the host's cost of issuing a search."""


def read(obs):
    return obs.host.get("enqueue_ms") if obs.kind == "search" else None
