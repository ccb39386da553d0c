"""Dynamic request batching for the serving paths (port of
``repro/serve/batching.py``; pure host code).

Requests accumulate in a queue; a batch fires when either ``max_batch`` is
reached or ``max_wait_s`` elapses with a non-empty queue — the standard
continuous-batching front-end.  ``serve_batch_fn`` runs on the batcher's
worker thread, so a CUDA search launches its kernels from that thread (on
its current stream); its results must already be on the host, because
``Request.done_t`` is stamped when it returns.

Shutdown contract: ``stop(drain=True)`` (the default) finishes everything
already queued before the worker exits; ``stop(drain=False)`` fails every
pending request fast — either way NO submitter is left hanging on an event
that will never be set (requests that are rejected or abandoned carry an
``error`` that ``__call__`` re-raises).  ``stats["stopped"]`` records which
path ran, with ``drained_on_stop`` / ``failed_on_stop`` counts.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    payload: Any
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    enqueue_t: float = dataclasses.field(default_factory=time.perf_counter)
    done_t: float = 0.0     # completion timestamp (perf_counter), set by
    #                         the worker — open-loop load generators read it
    #                         instead of timing event.wait() themselves

    def finish(self, result=None, error: BaseException | None = None):
        self.result = result
        self.error = error
        self.done_t = time.perf_counter()
        self.event.set()


class BatcherStopped(RuntimeError):
    """Raised to submitters whose request was rejected/failed at shutdown."""


class DynamicBatcher:
    def __init__(self, serve_batch_fn: Callable[[list], list],
                 max_batch: int = 64, max_wait_s: float = 0.005,
                 latency_window: int = 1024):
        """serve_batch_fn: list[payload] -> list[result] (padded inside).

        Latencies are kept in a fixed-size ring buffer of ``latency_window``
        samples (bounded memory under sustained traffic); p99_latency_ms is
        computed over that window.
        """
        self.fn = serve_batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.q: "queue.Queue[Request]" = queue.Queue()
        self._stop = threading.Event()
        self._drain = True
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self.stats = {"batches": 0, "requests": 0, "mean_batch": 0.0,
                      "p99_latency_ms": 0.0, "depth_peak": 0,
                      "stopped": None, "drained_on_stop": 0,
                      "failed_on_stop": 0}
        self._latencies = np.zeros(max(1, latency_window), np.float64)
        self._latency_count = 0      # total samples ever observed

    def start(self):
        self._worker.start()
        return self

    def stop(self, drain: bool = True):
        """Shut the worker down without abandoning queued requests.

        ``drain=True`` serves everything already queued, then exits;
        ``drain=False`` fails every pending request immediately with
        :class:`BatcherStopped`.  Either way, every ``Request.event`` ever
        handed out IS set — concurrent submitters never hang (they either
        get a result or the error re-raised from ``__call__``).
        """
        self._drain = drain
        self._stop.set()
        if self._worker.is_alive():
            self._worker.join(timeout=30)
        self._fail_pending()    # anything the worker didn't get to
        self.stats["stopped"] = "drained" if drain else "failed"

    def depth(self) -> int:
        """Current queue depth (approximate — the scheduling signal the
        serving runtime's degradation ladder keys on)."""
        return self.q.qsize()

    def submit(self, payload) -> Request:
        req = Request(payload)
        if self._stop.is_set():
            # fail-fast: the worker may already be gone; never enqueue a
            # request nobody will answer
            req.finish(error=BatcherStopped("batcher is stopped"))
            return req
        self.q.put(req)
        return req

    def __call__(self, payload, timeout: float = 30.0):
        req = self.submit(payload)
        if not req.event.wait(timeout):
            raise TimeoutError("serve request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def _fail_pending(self) -> int:
        n = 0
        while True:
            try:
                req = self.q.get_nowait()
            except queue.Empty:
                break
            req.finish(error=BatcherStopped("batcher stopped before "
                                            "this request was served"))
            n += 1
        self.stats["failed_on_stop"] += n
        return n

    def _loop(self):
        while True:
            if self._stop.is_set():
                if not self._drain or self.q.empty():
                    break
            depth = self.q.qsize()
            if depth > self.stats["depth_peak"]:
                self.stats["depth_peak"] = depth
            batch: list[Request] = []
            try:
                batch.append(self.q.get(timeout=0.05))
            except queue.Empty:
                continue
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                results = self.fn([r.payload for r in batch])
            except BaseException as exc:   # noqa: BLE001 — surfaced per-req
                for r in batch:
                    r.finish(error=exc)
                continue
            window = self._latencies.shape[0]
            for r, res in zip(batch, results):
                r.finish(result=res)
                self._latencies[self._latency_count % window] = \
                    (r.done_t - r.enqueue_t) * 1e3
                self._latency_count += 1
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            self.stats["mean_batch"] = (self.stats["requests"]
                                        / self.stats["batches"])
            if self._latency_count:
                filled = self._latencies[:min(self._latency_count, window)]
                self.stats["p99_latency_ms"] = float(
                    np.percentile(filled, 99))
            if self._stop.is_set() and self._drain:
                self.stats["drained_on_stop"] += len(batch)
