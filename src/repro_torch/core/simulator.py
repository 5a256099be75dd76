"""Profile-and-simulate engine (copy of ``repro.core.simulator``; paper
Section VI methodology).

Per-iteration MoE inference time is assembled layer by layer from the
analytic models:

* attention compute (roofline over ``DeviceSpec``),
* attention all-reduce (mesh ring / entwined ring / hierarchical, or the
  switched-cluster reference),
* MoE all-to-all dispatch+combine (FTD-confined mesh model or cluster),
* expert compute (max over devices, honouring load imbalance, replicas and
  ESP sharding),
* PipeMoE-style communication/computation pipelining with ``stages``
  micro-batches,
* an optional migration stream (NI-Balancer) riding cold-link slack.

``run_serving_trace`` drives the whole loop over a load trace: EMA load
observation -> Eq. 2 trigger -> balance plan -> migration engine -> layer
times (Figs. 15-17). The balancer is the port's own
``repro_torch.core.ni_balancer`` over its ``PlacementTable``, the one the
serving runtime runs. Every time here is a model output for the paper's
platforms (``core/hardware.py``), not a measurement.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import comm_model as cm
from repro_torch.core.er_mapping import Mapping
from repro_torch.core.hardware import PlatformSpec
from repro_torch.core.migration import MigrationEngine
from repro_torch.core.ni_balancer import (
    BalancerState,
    greedy_balance,
    prune_replicas,
    should_trigger,
    topology_aware_balance,
)
from repro_torch.core.traces import LoadTrace
from repro_torch.core.workloads import SimModelSpec


@dataclasses.dataclass
class IterationBreakdown:
    attn_compute: float
    allreduce: float
    alltoall: float
    moe_compute: float
    migration_exposed: float
    total: float

    @staticmethod
    def zeros() -> "IterationBreakdown":
        return IterationBreakdown(0, 0, 0, 0, 0, 0)


def _overlap(comp: float, comm: float, stages: int) -> float:
    """PipeMoE-style pipelined overlap with ``stages`` micro-batches: the
    longer stream hides the shorter except for one stage's worth."""
    if stages <= 1:
        return comp + comm
    longer, shorter = max(comp, comm), min(comp, comm)
    return longer + shorter / stages


@dataclasses.dataclass
class WSCSystem:
    """A (multi-)wafer system under a given mapping."""

    platform: PlatformSpec
    mapping: Mapping
    hierarchical: bool = False        # HER-Mapping all-reduce
    retain_ag: bool = True

    @property
    def n_devices(self) -> int:
        return self.mapping.topo.n_devices

    def allreduce(self, bytes_per_device: float) -> cm.CommResult:
        if self.hierarchical and self.mapping.topo.n_wafers > 1:
            return cm.hier_allreduce(self.mapping, self.platform, bytes_per_device)
        return cm.mesh_allreduce(
            self.mapping, self.platform, bytes_per_device, self.retain_ag
        )

    def esp_allreduce(self, bytes_per_device: float) -> cm.CommResult:
        """ESP communication (paper Section VI-B5): the cluster-wide
        all-to-all is eliminated; what remains is a token gather +
        partial-sum combine *within* each FTD (two ring phases): compact
        1-hop tiles under ER-Mapping, spread multi-hop rings under the
        baseline placement."""
        return cm.mesh_allreduce(
            self.mapping, self.platform, bytes_per_device,
            retain_ag=True, groups=self.mapping.ftds,
        )

    def alltoall(self, wl: cm.A2AWorkload) -> cm.CommResult:
        return cm.mesh_alltoall(self.mapping, self.platform, wl, self.retain_ag)

    def distance(self, a: int, b: int) -> float:
        topo = self.mapping.topo
        return topo.hops(topo.coord(a), topo.coord(b))


@dataclasses.dataclass
class ClusterSystem:
    """Switched reference system (DGX / NVL72)."""

    platform: PlatformSpec
    n_devices: int
    tp: int = 8

    def allreduce(self, bytes_per_device: float) -> cm.CommResult:
        # TP group = the reduction domain (kept inside an NVLink island).
        return cm.cluster_allreduce(self.platform, self.tp, bytes_per_device)

    def esp_allreduce(self, bytes_per_device: float) -> cm.CommResult:
        return self.allreduce(bytes_per_device)

    def alltoall(self, wl: cm.A2AWorkload) -> cm.CommResult:
        # Each TP rank dispatches its group's tokens once: per-device egress.
        per_dev = wl.tokens_per_group * wl.topk * wl.token_bytes / self.tp
        imb = 1.0
        if wl.device_load is not None:
            imb = float(np.max(wl.device_load))
        return cm.cluster_alltoall(self.platform, self.n_devices, per_dev, imb)

    def distance(self, a: int, b: int) -> float:
        s = self.platform.group_size
        return 0.0 if a // s == b // s else 1.0


# ---------------------------------------------------------------------------
# one iteration
# ---------------------------------------------------------------------------

def simulate_iteration(
    model: SimModelSpec,
    system,
    tokens_per_group: int,
    tp: int,
    state: BalancerState | None = None,
    stages: int = 4,
    migration_exposed: float = 0.0,
    engine: MigrationEngine | None = None,
) -> IterationBreakdown:
    """Latency of one decode/prefill iteration over all sparse layers."""
    dev = system.platform.device
    n = system.n_devices
    dp = n // tp

    # --- attention phase ---------------------------------------------------
    # Each TP rank computes tokens_per_group tokens over 1/tp of the heads.
    attn_flops = tokens_per_group * model.attn_flops_token / tp
    attn_bytes = model.attn_params * 2 / tp  # FP16 attention weights
    attn_comp = dev.compute_time(attn_flops, attn_bytes)
    ar = system.allreduce(tokens_per_group * model.token_bytes)
    attn_phase = _overlap(attn_comp, ar.time, stages)

    # --- MoE phase -----------------------------------------------------------
    device_load = state.device_token_share() if state is not None else None
    wl = cm.A2AWorkload(
        tokens_per_group=tokens_per_group,
        token_bytes=model.token_bytes,
        topk=model.topk,
        device_load=device_load,
    )
    if model.n_experts < n:
        # ESP regime (paper Section VI-B5): experts sharded across devices;
        # tokens stay put, so the all-to-all is *eliminated* and an extra
        # all-reduce (partial-sum combine within EP groups = FTDs) dominates.
        a2a = system.esp_allreduce(tokens_per_group * model.token_bytes)
    else:
        a2a = system.alltoall(wl)

    # Expert compute: tokens land per device proportionally to its heat.
    total_dispatch = dp * tokens_per_group * model.topk
    mean_tokens = total_dispatch / n
    max_share = float(np.max(device_load)) if device_load is not None else 1.0
    tokens_hot = mean_tokens * max_share
    if model.n_experts >= n:
        experts_per_dev = model.n_experts / n
        weight_bytes = experts_per_dev * model.expert_bytes
        flops = tokens_hot * model.expert_flops_token
    else:
        # ESP: each expert sharded over n/E devices (Section VI-B5).
        shard = model.n_experts / n
        weight_bytes = model.expert_bytes * shard
        flops = tokens_hot * model.expert_flops_token * shard
    moe_comp = dev.compute_time(flops, weight_bytes)
    moe_phase = _overlap(moe_comp, a2a.time, stages)

    # --- migration stream -------------------------------------------------------
    if engine is not None:
        engine.step_iteration(attn_phase, moe_phase, ar.link_loads, a2a.link_loads)

    per_layer = attn_phase + moe_phase
    total = model.layers_sparse * per_layer + migration_exposed
    return IterationBreakdown(
        attn_compute=model.layers_sparse * attn_comp,
        allreduce=model.layers_sparse * ar.time,
        alltoall=model.layers_sparse * a2a.time,
        moe_compute=model.layers_sparse * moe_comp,
        migration_exposed=migration_exposed,
        total=total,
    )


# ---------------------------------------------------------------------------
# trace-driven serving loop (Figs. 15-17)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingResult:
    iteration_times: np.ndarray
    peak_over_mean: np.ndarray        # device load imbalance per iteration
    exposed_overhead: float           # total migration stall time
    migrations: int
    breakdown_last: IterationBreakdown


BALANCERS = ("none", "greedy", "topo", "topo_ni")


def run_serving_trace(
    model: SimModelSpec,
    system,
    trace: LoadTrace,
    tokens_per_group: int,
    tp: int,
    balancer: str = "none",
    alpha: float = 2.0,
    beta_iters: int = 10,
    slots_per_device: int | None = None,
    stages: int = 4,
) -> ServingResult:
    if balancer not in BALANCERS:
        raise ValueError(f"balancer {balancer!r} is not one of {BALANCERS}")
    n = system.n_devices
    n_exp = trace.n_experts
    slots = slots_per_device or (max(n_exp // n, 1) + 1)
    state = BalancerState.initial(n_exp, n, slots)
    mode = "noninvasive" if balancer == "topo_ni" else "invasive"
    engine = None
    if balancer != "none" and isinstance(system, WSCSystem):
        engine = MigrationEngine(
            system.mapping, system.platform, model.expert_bytes, mode=mode
        )

    times = []
    imb = []
    total_exposed = 0.0
    n_migs = 0
    last_mig_iter = -(10**9)
    bd = IterationBreakdown.zeros()
    per_trigger = max(n // 8, 4)   # bounded agility per trigger

    for t in range(trace.n_iterations):
        loads = trace.loads[t]
        state.observe(loads)

        exposed = 0.0
        if balancer != "none" and should_trigger(
            [loads], alpha, t - last_mig_iter, 0 if balancer == "topo_ni" else beta_iters
        ):
            prune_replicas(state)
            if balancer == "greedy":
                plan = greedy_balance(state, max_migrations=per_trigger)
            else:
                plan = topology_aware_balance(
                    state, system.distance, max_migrations=per_trigger
                )
            if plan:
                last_mig_iter = t
                n_migs += len(plan)
                if engine is not None:
                    exposed = engine.submit(plan)
                for m in plan:
                    state.apply(m)
        total_exposed += exposed

        # The load-aware state drives compute/imbalance for every policy
        # (including "none"): policies differ only in migrations.
        bd = simulate_iteration(
            model,
            system,
            tokens_per_group,
            tp,
            state=state,
            stages=stages,
            migration_exposed=exposed,
            engine=engine,
        )
        times.append(bd.total)
        imb.append(float(np.max(state.device_token_share())))

    return ServingResult(
        iteration_times=np.array(times),
        peak_over_mean=np.array(imb),
        exposed_overhead=total_exposed,
        migrations=n_migs,
        breakdown_last=bd,
    )
