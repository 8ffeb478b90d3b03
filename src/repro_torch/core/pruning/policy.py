"""The pruning-policy search loop — Algorithm 1, lines 3-19 (the port of
the JAX package's ``core/pruning/policy.py``).

Runs DDPG episodes over the PruningEnv, stores per-layer transitions with
the episode's terminal accuracy as the (shared) reward — AMC's credit
assignment — updates the agent from replay, and tracks the best strategy
found. Exploration noise sigma starts at 0.5, stays fixed for ``warmup``
episodes, then decays exponentially (paper §4.2).

Two generators, as in the reference: the agent's (its weights from the
seed, the exploration noise from a ``torch.Generator`` seeded with it) and
``np.random.RandomState(seed)`` for the replay draws. The agent lives on
``device``; each action reads the actor's output back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.pruning.amc_env import STATE_DIM, PruningEnv
from repro_torch.core.pruning.ddpg import (ReplayBuffer, actor_apply,
                                           agent_update, init_agent,
                                           truncated_normal_action)
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class SearchResult:
    best_ratios: List[float]
    best_reward: float
    best_flops_kept: float
    history: List[Dict] = field(default_factory=list)


def search_pruning_policy(env: PruningEnv,
                          episodes: int = 120,
                          warmup: int = 20,
                          sigma0: float = 0.5,
                          sigma_decay: float = 0.97,
                          batch_size: int = 32,
                          updates_per_episode: int = 5,
                          seed: int = 0,
                          log: Optional[Callable[[str], None]] = None,
                          device: DeviceLike = None) -> SearchResult:
    """Search a per-layer preserve ratio for ``env``'s layers with the
    agent on ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.RandomState(seed)
    agent = init_agent(seed, STATE_DIM, device=device)
    buf = ReplayBuffer(STATE_DIM, capacity=500)
    baseline = 0.0
    best = SearchResult([], -1.0, 0.0)
    sigma = sigma0

    for ep in range(episodes):
        def act(state, layer_idx):
            with torch.no_grad():
                mu = float(actor_apply(
                    agent.actor, torch.from_numpy(state[None]).to(device))[0])
            # pure exploration around mu with fixed sigma for the warm-up
            # episodes (paper: the first 100 iterations keep sigma = 0.5)
            return float(truncated_normal_action(
                gen, mu, sigma0 if ep < warmup else sigma))

        rec = env.run_episode(act)
        r = rec["reward"]
        baseline = 0.95 * baseline + 0.05 * r if ep else r
        for t, (s, a, s2) in enumerate(zip(rec["states"], rec["actions"],
                                           rec["next_states"])):
            done = 1.0 if t == len(rec["states"]) - 1 else 0.0
            buf.add(s, a, r, s2, done)
        if buf.n >= batch_size:
            for _ in range(updates_per_episode):
                agent, _ = agent_update(
                    agent, buf.sample(rng, batch_size, device=device),
                    baseline)
        if ep >= warmup:
            sigma = max(sigma * sigma_decay, 0.02)
        if r > best.best_reward:
            best = SearchResult(list(rec["actions"]), r, rec["flops_kept"],
                                best.history)
        best.history.append({"episode": ep, "reward": r,
                             "flops_kept": rec["flops_kept"],
                             "sigma": sigma})
        if log and (ep % 10 == 0 or ep == episodes - 1):
            log(f"ep {ep:4d} reward={r:.4f} kept={rec['flops_kept']:.3f} "
                f"sigma={sigma:.3f} best={best.best_reward:.4f}")
    return best
