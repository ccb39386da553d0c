"""Kernel B's least time over its device time, in percent.

The device time is the summed duration of the traced window's kernels whose
name holds ``fused_gather_topk``; the least time is the sum over the
window's batches of the larger of the rerank's ops over the fp32 peak and
its bytes over the HBM bandwidth, counted from the reference's candidate
lists (``bench/workcount.py``)."""


def read(obs):
    us = obs.kernel_us("fused_gather_topk")
    least = obs.work.get("rerank_least_s")
    if obs.kind != "search" or not us or not least:
        return None
    return 100.0 * least / (us / 1e6)
