"""Trainer callbacks (port of ``latte_tpu/train/callbacks.py``).

Subclass :class:`Callback` and override any hook; attach via
``train.main(config, callbacks=[...])``. Hooks run on the host between
steps, so they can read metrics, write external logs, or request an early
stop.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class Callback:
    """No-op base; override the hooks you need."""

    def on_train_start(self, config, state, experiment_dir: str) -> None:
        pass

    def on_log(self, step: int, metrics: Dict[str, float]) -> None:
        """After each log interval, with host-materialized metrics."""

    def on_checkpoint(self, step: int, path: str) -> None:
        """After a checkpoint save has been issued. Under
        ``async_checkpoint`` (the default) the file is complete only after
        ``train.checkpoint.wait_for_saves()``, as in JAX."""

    def on_train_end(self, result: Dict[str, Any]) -> None:
        pass

    def should_stop(self, step: int, metrics: Dict[str, float]) -> bool:
        """Return True (at a log boundary) to end training early."""
        return False


class CallbackList:
    """Fans hooks out to each callback; `should_stop` is an any()."""

    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def on_train_start(self, config, state, experiment_dir):
        for c in self.callbacks:
            c.on_train_start(config, state, experiment_dir)

    def on_log(self, step, metrics):
        for c in self.callbacks:
            c.on_log(step, metrics)

    def on_checkpoint(self, step, path):
        for c in self.callbacks:
            c.on_checkpoint(step, path)

    def on_train_end(self, result):
        for c in self.callbacks:
            c.on_train_end(result)

    def should_stop(self, step, metrics) -> bool:
        return any(c.should_stop(step, metrics) for c in self.callbacks)


class EarlyStopOnNaN(Callback):
    """Stop (and flag) when the logged loss goes non-finite."""

    def __init__(self):
        self.tripped = False

    def should_stop(self, step, metrics) -> bool:
        import math

        loss = metrics.get("loss")
        if loss is not None and not math.isfinite(loss):
            self.tripped = True
        return self.tripped
