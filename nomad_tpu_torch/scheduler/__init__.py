"""Scheduler package: placement logic behind a Factory registry.

Port of nomad_tpu.scheduler's registry (reference seam: upstream
scheduler/scheduler.go:13-87). The host ``service``/``batch`` schedulers
and the device-backed ``tpu-service``/``tpu-batch`` factories register
here. Unlike nomad_tpu, there is no subprocess device probe and no
circuit breaker that reroutes to the host oracle: a ``tpu-*`` factory
runs the port's device solver on the requested device, or raises.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Protocol, Tuple

from nomad_tpu_torch.structs import Evaluation, Plan, PlanResult


class SchedulerError(Exception):
    pass


class SetStatusError(SchedulerError):
    """Processing failed and the eval should be moved to ``eval_status``
    (reference: generic_sched.go:32-40)."""

    def __init__(self, err: str, eval_status: str):
        super().__init__(err)
        self.eval_status = eval_status


class State(Protocol):
    """Immutable view of global state (reference: scheduler/scheduler.go:55-71)."""

    def nodes(self): ...
    def allocs_by_job(self, job_id: str): ...
    def allocs_by_node(self, node_id: str): ...
    def node_by_id(self, node_id: str): ...
    def job_by_id(self, job_id: str): ...


class Planner(Protocol):
    """Plan submission interface (reference: scheduler/scheduler.go:74-87)."""

    def submit_plan(self, plan: Plan) -> Tuple[PlanResult, Optional[State]]: ...
    def update_eval(self, ev: Evaluation) -> None: ...
    def create_eval(self, ev: Evaluation) -> None: ...


class Scheduler(Protocol):
    def process(self, ev: Evaluation) -> None: ...


# Factories take the target device as a fourth argument; host schedulers
# ignore it.
Factory = Callable[..., Scheduler]

BUILTIN_SCHEDULERS: Dict[str, Factory] = {}


def register(name: str, factory: Factory) -> None:
    BUILTIN_SCHEDULERS[name] = factory


def new_scheduler(
    name: str,
    state: State,
    planner: Planner,
    logger: Optional[logging.Logger] = None,
    device=None,
) -> Scheduler:
    """Instantiate a scheduler by name (reference: scheduler.go:19-31).
    ``device`` (default: the CUDA card) is where ``tpu-*`` schedulers
    solve; asking for CUDA without a card raises."""
    factory = BUILTIN_SCHEDULERS.get(name)
    if factory is None:
        raise SchedulerError(f"unknown scheduler '{name}'")
    return factory(state, planner,
                   logger or logging.getLogger("nomad_tpu_torch.sched"),
                   device)


def _register_builtins() -> None:
    from nomad_tpu_torch.scheduler.generic import (
        new_batch_scheduler,
        new_service_scheduler,
    )

    register("service", lambda s, p, log, _dev=None:
             new_service_scheduler(s, p, log))
    register("batch", lambda s, p, log, _dev=None:
             new_batch_scheduler(s, p, log))

    # No device probe and no DEVICE_BREAKER host fallback (nomad_tpu
    # scheduler/__init__.py:95-283,297-312): the device solver or an error.
    def _device(variant: str) -> Factory:
        def factory(state, planner, logger, device=None):
            from nomad_tpu_torch.tpu import solver

            return solver.new_tpu_scheduler(variant, state, planner, logger,
                                            device=device)

        return factory

    register("tpu-service", _device("service"))
    register("tpu-batch", _device("batch"))


_register_builtins()
