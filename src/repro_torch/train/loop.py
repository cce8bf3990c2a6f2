# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Fault-tolerant training loop (port of ``repro/train/loop.py``).

  * checkpoint/restart: ``save_async`` every ``ckpt_every`` steps and a
    final save, through ``repro_torch.ckpt`` (the JAX store's layout, so
    either package resumes the other's run); on (re)start the loop
    resumes from the latest COMMITTED step, so a kill loses at most
    ``ckpt_every`` steps.
  * preemption: ``preemption_signal`` is polled every step; when it fires
    the loop saves synchronously and exits cleanly.
  * stragglers: each step's time is tracked with an EMA; a step slower
    than ``straggler_factor`` x the EMA is recorded; ``max_step_s`` is a
    hard watchdog that raises.  The time source is injectable
    (``clock=``), so both policies are testable deterministically.
  * data: ``next_batch(step)``; deterministic per-step batches make a
    restart reproducible.

A step ends in one host sync: the metrics are stacked and read with one
``tolist()`` (the reference's ``jax.device_get``), which also times the
step honestly, since the device has then finished it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .optim import OptState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    max_step_s: Optional[float] = None  # hard watchdog


@dataclasses.dataclass
class LoopReport:
    start_step: int
    end_step: int
    preempted: bool
    stragglers: List[int]
    last_metrics: Dict[str, float]


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics (scalar tensors on one device) as floats, in one
    device-to-host copy."""
    from repro_torch.launch.mesh import full_tensor

    if not metrics:
        return {}
    host = torch.stack([full_tensor(torch.as_tensor(v)).float().reshape(())
                        for v in metrics.values()])
    return dict(zip(metrics, host.tolist()))


def run_training(
    train_step: Callable,  # (params, opt, batch) -> (params, opt, metrics)
    params: Any,
    opt_state: OptState,
    next_batch: Callable[[int], Any],
    store,
    cfg: LoopConfig,
    *,
    preemption_signal: Callable[[], bool] = lambda: False,
    log: Callable[[str], None] = print,
    clock: Callable[[], float] = time.time,
) -> Tuple[Any, OptState, LoopReport]:
    """Run (or resume) training to ``cfg.total_steps`` -> (params,
    opt_state, LoopReport).  ``store`` is a ``repro_torch.ckpt``
    ``CheckpointStore`` or ``MemoryStore``; ``clock`` the step-timing
    source (monotone seconds)."""
    start_step = 0
    latest = store.latest_step()
    if latest is not None:
        (params, opt_state), extra = store.load(latest, (params, opt_state))
        start_step = int(extra.get("step", latest))
        log(f"[loop] resumed from checkpoint step {start_step}")

    ema: Optional[float] = None
    stragglers: List[int] = []
    metrics_host: Dict[str, float] = {}
    preempted = False

    step = start_step
    while step < cfg.total_steps:
        batch = next_batch(step)
        t0 = clock()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        metrics_host = _to_host(metrics)
        dt = clock() - t0
        step += 1

        if ema is not None and dt > cfg.straggler_factor * ema:
            stragglers.append(step)
            log(f"[loop] straggler step {step}: {dt:.3f}s vs EMA {ema:.3f}s")
        if cfg.max_step_s is not None and dt > cfg.max_step_s:
            raise TimeoutError(
                f"step {step} took {dt:.1f}s > watchdog {cfg.max_step_s}s")
        ema = dt if ema is None else cfg.ema_decay * ema + (
            1 - cfg.ema_decay) * dt

        if step % cfg.log_every == 0:
            log(f"[loop] step {step}: " + " ".join(
                f"{k}={v:.4g}" for k, v in sorted(metrics_host.items())))

        if step % cfg.ckpt_every == 0 and step < cfg.total_steps:
            store.save_async(step, (params, opt_state), {"step": step})

        if preemption_signal():
            store.wait()
            store.save(step, (params, opt_state), {"step": step})
            log(f"[loop] preempted at step {step}; checkpoint committed")
            preempted = True
            break

    store.wait()
    if not preempted:
        store.save(step, (params, opt_state), {"step": step})
    return params, opt_state, LoopReport(
        start_step=start_step, end_step=step, preempted=preempted,
        stragglers=stragglers, last_metrics=metrics_host)
