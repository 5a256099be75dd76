"""Synthetic expert-load traces with the paper's statistical structure
(copy of ``repro.core.traces``: the same numpy generators, so a seed gives
the same trace).

Section V-B observes: (a) per-scenario expert popularity is *stable* after a
brief warm-up (intrinsically popular experts + domain-specific experts),
(b) production serving sees *cyclically evolving scenario mixtures* (Azure
arrival traces), inducing slow-varying device-load ratios.

We generate loads accordingly: each scenario draws a fixed Dirichlet expert-
popularity vector per layer; a mixed trace blends scenarios with slowly
rotating weights; per-iteration loads are multinomial draws, giving both the
stable ratios of Fig. 12 and the drift that forces continuous rebalancing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SCENARIOS = ("chat", "coding", "math", "privacy")


@dataclasses.dataclass
class LoadTrace:
    """loads[t, e] = token count routed to expert e at iteration t."""

    loads: np.ndarray
    scenario: str

    @property
    def n_iterations(self) -> int:
        return self.loads.shape[0]

    @property
    def n_experts(self) -> int:
        return self.loads.shape[1]


def scenario_popularity(
    n_experts: int, scenario: str, seed: int = 0, concentration: float = 0.05
) -> np.ndarray:
    """Stable expert-popularity vector for one scenario (sums to 1).

    Low Dirichlet concentration yields the skewed, peaky distributions the
    paper profiles — calibrated so that folding experts onto 8 devices gives
    peak device loads of ~2-3x the average (paper Fig. 12: up to 2.9x).
    """
    idx = SCENARIOS.index(scenario)
    rng = np.random.default_rng(seed * 1000 + idx)
    pop = rng.dirichlet(np.full(n_experts, concentration))
    # Intrinsic popularity bias shared across scenarios (paper cites [3]).
    shared = np.random.default_rng(seed).dirichlet(np.full(n_experts, 0.15))
    return 0.85 * pop + 0.15 * shared


def single_scenario_trace(
    n_experts: int,
    tokens_per_iter: int,
    n_iterations: int,
    scenario: str = "math",
    seed: int = 0,
) -> LoadTrace:
    pop = scenario_popularity(n_experts, scenario, seed)
    rng = np.random.default_rng(seed + 7)
    loads = rng.multinomial(tokens_per_iter, pop, size=n_iterations).astype(float)
    return LoadTrace(loads=loads, scenario=scenario)


def mixed_scenario_trace(
    n_experts: int,
    tokens_per_iter: int,
    n_iterations: int,
    period: int = 400,
    seed: int = 0,
) -> LoadTrace:
    """Cyclically drifting scenario mixture (Azure-style request pools)."""
    pops = np.stack(
        [scenario_popularity(n_experts, s, seed) for s in SCENARIOS]
    )  # (S, E)
    t = np.arange(n_iterations)[:, None]
    phases = np.linspace(0, 2 * np.pi, len(SCENARIOS), endpoint=False)[None, :]
    # Slowly rotating softmax mixture weights.
    logits = 1.5 * np.sin(2 * np.pi * t / period + phases)
    w = np.exp(logits)
    w /= w.sum(axis=1, keepdims=True)              # (T, S)
    probs = w @ pops                               # (T, E)
    rng = np.random.default_rng(seed + 13)
    loads = np.stack(
        [rng.multinomial(tokens_per_iter, probs[i]) for i in range(n_iterations)]
    ).astype(float)
    return LoadTrace(loads=loads, scenario="mixed")


def device_load_ratios(loads: np.ndarray, n_devices: int) -> np.ndarray:
    """Fold expert loads onto devices (expert e -> device e % n_devices),
    returning per-iteration device load / mean — the Fig. 12 quantity."""
    t, e = loads.shape
    dev = np.zeros((t, n_devices))
    for expert in range(e):
        dev[:, expert % n_devices] += loads[:, expert]
    mean = dev.mean(axis=1, keepdims=True)
    return dev / np.maximum(mean, 1e-12)
