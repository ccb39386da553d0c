"""Device ms a batch in kernels that are neither the descent (names holding
``forest_traverse``) nor the rerank (``fused_gather_topk``): the leaf
slice, the dedup sort, gathers and wheres."""


def read(obs):
    if obs.kind != "search" or not obs.units or not obs.kernels:
        return None
    us = sum(e - s for n, s, e in obs.kernels
             if "forest_traverse" not in n and "fused_gather_topk" not in n)
    return us / obs.units / 1e3
