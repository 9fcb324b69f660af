"""In-process scale simulation & load generation for the port's control
plane (port of nomad_tpu/simcluster).

A :class:`~nomad_tpu_torch.simcluster.simnode.SimFleet` of lightweight
node agents drives a real ``ClusterServer`` over real RPC — batched
registration, TTL heartbeats, alloc acknowledgement — while seeded
workload injectors (:mod:`~nomad_tpu_torch.simcluster.workload`) push jobs
through the full register→heartbeat→eval→broker→worker→solver→
plan_apply→raft path on the device, and the scenario runner
(:mod:`~nomad_tpu_torch.simcluster.scenario`) watches the cluster event
stream and emits one JSON artifact per run.

Determinism posture: the injectors draw the reference's seeded streams,
job and node ids are derived from the seed, and the artifact carries the
canonical event digest (the multiset of per-key event-type sequences), so
a run is checkable against a same-seed replay and against nomad_tpu's
runner on the same scenario. Importing the package registers the chaos
families (``chaos``) beside the registry's scenarios.
"""

from nomad_tpu_torch.simcluster.scenario import (  # noqa: F401
    SCENARIOS,
    ScenarioRunner,
    run_scenario,
)
from nomad_tpu_torch.simcluster.simnode import SimFleet, sim_node  # noqa: F401
from nomad_tpu_torch.simcluster.workload import (  # noqa: F401
    BatchBurstInjector,
    ExpressStreamInjector,
    NodeChurnInjector,
    SteadyServiceInjector,
    UpdateChurnInjector,
)

from nomad_tpu_torch.simcluster import chaos  # noqa: E402,F401
