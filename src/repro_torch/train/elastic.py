"""Elastic scaling + failure handling plans (``repro.train.elastic``,
copied: plain Python, no device code).

The contracts:

 * ``remesh_plan(base_shape, axis_names, n_failed)`` — given failed hosts,
   produce the largest healthy mesh that preserves the model axis (TP
   degree is a property of the checkpointed layout; the data axis
   shrinks).
 * ``StepBudget`` — straggler mitigation: per-step deadline accounting;
   the ISLA time-constraint extension means telemetry degrades gracefully
   (prefix moments) instead of blocking the step.
 * Recovery = restore the last committed checkpoint
   (``train.checkpoint``) + replay the deterministic data stream from
   that step (``train.data``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_devices: int
    dropped_hosts: Tuple[int, ...]
    note: str


def largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def remesh_plan(base_shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                n_failed_data_groups: int) -> RemeshPlan:
    """Shrink the data axis to the largest power of two that the surviving
    hosts can fill; keep model (TP) and pod axes intact."""
    shape = list(base_shape)
    names = list(axis_names)
    di = names.index("data")
    healthy = shape[di] - n_failed_data_groups
    if healthy < 1:
        raise RuntimeError("no healthy data groups left")
    new_data = largest_pow2_leq(healthy)
    shape[di] = new_data
    n = 1
    for s in shape:
        n *= s
    return RemeshPlan(
        shape=tuple(shape), axis_names=tuple(names), n_devices=n,
        dropped_hosts=tuple(range(new_data, base_shape[di])),
        note=(f"data axis {base_shape[di]} -> {new_data} "
              f"after {n_failed_data_groups} failures"))


def rescale_batch(global_batch: int, old_data: int, new_data: int,
                  keep_global: bool = True) -> Tuple[int, int]:
    """(new_global_batch, grad_accum_factor).

    keep_global=True preserves the optimization trajectory by trading the
    lost data-parallelism for gradient accumulation (microbatches)."""
    if keep_global:
        if global_batch % new_data != 0:
            raise ValueError(f"batch {global_batch} % data {new_data} != 0")
        accum = max(1, old_data // new_data)
        return global_batch, accum
    return global_batch * new_data // old_data, 1


@dataclasses.dataclass
class StepBudget:
    """Wall-clock budget for a step phase; used by the supervisor to detect
    stragglers and by ISLA telemetry to cap sample quotas (§VII-F)."""

    seconds: float
    started: float = dataclasses.field(default_factory=time.monotonic)

    def remaining(self) -> float:
        return self.seconds - (time.monotonic() - self.started)

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def sample_quota(self, full_quota: int) -> int:
        """Scale an ISLA sampling quota by the remaining budget fraction —
        moments are valid at any prefix, so a straggler block contributes
        what it has."""
        frac = max(0.0, min(1.0, self.remaining() / self.seconds))
        return max(1, int(full_quota * frac))


class FailureInjector:
    """Deterministic failure schedule for drills: fail data-group ``g`` at
    step ``s``."""

    def __init__(self, schedule: Sequence[Tuple[int, int]]):
        self.schedule = dict(schedule)  # step -> n_failures

    def failures_at(self, step: int) -> int:
        """Returns and CONSUMES the injection (a failure is a one-time event;
        the post-recovery replay must not re-fire it)."""
        return self.schedule.pop(step, 0)
