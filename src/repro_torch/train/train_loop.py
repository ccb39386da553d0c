"""Training loop with fault-tolerance plumbing (port of
``repro/train/train_loop.py``).

  * checkpoint cadence + resume from the latest checkpoint (either
    package's: the leaf names are the reference's),
  * preemption handling (SIGTERM -> final checkpoint -> clean exit; the
    handler is ``checkpoint.checkpointer.install_preemption_handler``),
  * straggler watchdog: an EMA of step wall times; a step slower than
    ``straggler_factor`` x EMA is logged and counted and left out of the
    EMA,
  * the history of losses, steps and step times.

Each step ends by reading its loss on the host, which waits for the
device: the port's counterpart of ``jax.block_until_ready``, so a step's
time is its device time plus the host's.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer, preempted
from repro_torch.train.train_state import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 0              # 0 = no checkpointing
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_async: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_warmup: int = 5


class Watchdog:
    """EMA step-time monitor; flags straggling steps."""

    def __init__(self, factor: float, warmup: int):
        self.factor = factor
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.events: list[tuple[int, float]] = []
        self.n = 0

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        straggled = False
        if self.ema is not None and self.n > self.warmup \
                and dt > self.factor * self.ema:
            self.events.append((step, dt))
            straggled = True
        # straggler steps stay out of the EMA, so one hiccup does not mask
        # the next
        if not straggled:
            self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        return straggled


def train(state: TrainState, train_step: Callable, batches, cfg: LoopConfig,
          on_straggler: Optional[Callable] = None) -> tuple[TrainState, dict]:
    """batches: iterator of batch trees. Returns (state, history)."""
    ckpt = Checkpointer(cfg.ckpt_dir) if cfg.ckpt_every else None
    if ckpt is not None and ckpt.latest_step() is not None:
        step0 = ckpt.restore_into(state)
        print(f"[train] resumed from step {step0}")
    watchdog = Watchdog(cfg.straggler_factor, cfg.straggler_warmup)
    history: dict[str, list] = {"loss": [], "step": [], "dt": []}

    start_step = int(state.step)
    for i, batch in enumerate(batches):
        step = start_step + i
        if step >= cfg.total_steps:
            break
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])       # waits for the device
        dt = time.perf_counter() - t0
        if watchdog.observe(step, dt) and on_straggler is not None:
            on_straggler(step, dt)
        history["loss"].append(loss)
        history["step"].append(step)
        history["dt"].append(dt)
        if cfg.log_every and step % cfg.log_every == 0:
            print(f"[train] step={step} loss={loss:.4f} dt={dt*1e3:.1f}ms")
        if ckpt is not None and (step + 1) % cfg.ckpt_every == 0:
            ckpt.save(int(state.step), state, block=not cfg.ckpt_async)
        if preempted():
            print("[train] preemption signal -> final checkpoint + exit")
            break
    if ckpt is not None:
        ckpt.save(int(state.step), state, block=True)
    history["straggler_events"] = watchdog.events
    return state, history
