"""DDPG agent for layer-wise sparsity search (paper §3.2, Eqs. 2-4), the
port of the JAX package's ``core/pruning/ddpg.py``.

Actor and critic are 2x300-unit MLPs (paper §4.2), lists of ``{"w", "b"}``
tensors on one device. The critic target is the baseline-subtracted
one-step return of Eq. 3 with gamma = 1; exploration uses truncated-normal
noise around the actor output (Eq. 4) with sigma_0 = 0.5 decaying
exponentially after a warm-up number of episodes (paper: 100).

``agent_update`` runs on autograd in the reference's order: the target
from the target nets, the critic's MSE step, the actor's step against the
*new* critic (no gradient reaches the critic), both Adam steps sharing
``agent.step``, then the soft target updates. The weights are drawn from
numpy and the noise from an explicit ``torch.Generator``; the reference
draws both from ``jax.random``, so the two agents differ in their draws,
never in their arithmetic. The replay buffer is a small numpy ring
(paper: 500 transitions).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.optimizers import tree_map, value_and_grad

HIDDEN = 300
ACTION_LO, ACTION_HI = 0.05, 1.0     # a in (0, 1]

Mlp = List[Dict[str, torch.Tensor]]


def _mlp_init(rng: np.random.Generator, sizes, device: torch.device) -> Mlp:
    params = []
    for i, o in zip(sizes[:-1], sizes[1:]):
        w = rng.standard_normal((i, o), dtype=np.float32) * np.float32(
            math.sqrt(2.0 / i))
        params.append({"w": torch.from_numpy(w).to(device),
                       "b": torch.zeros(o, dtype=torch.float32,
                                        device=device)})
    return params


def _mlp_apply(params: Mlp, x: torch.Tensor, final_act=None) -> torch.Tensor:
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return final_act(x) if final_act else x


def actor_apply(params: Mlp, state: torch.Tensor) -> torch.Tensor:
    """state (..., S) -> action in (0, 1]."""
    a = _mlp_apply(params, state, torch.sigmoid)[..., 0]
    return ACTION_LO + (ACTION_HI - ACTION_LO) * a


def critic_apply(params: Mlp, state: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
    x = torch.cat([state, action[..., None]], -1)
    return _mlp_apply(params, x)[..., 0]


class AgentState(NamedTuple):
    actor: Mlp
    critic: Mlp
    actor_tgt: Mlp
    critic_tgt: Mlp
    actor_opt: Dict
    critic_opt: Dict
    step: int


def init_agent(seed: int, state_dim: int,
               device: DeviceLike = None) -> AgentState:
    """A fresh agent on ``device`` (the card unless the caller names
    another), its weights He-normal from ``np.random.default_rng(seed)``:
    the same seed gives the same weights on every device."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    actor = _mlp_init(rng, [state_dim, HIDDEN, HIDDEN, 1], device)
    critic = _mlp_init(rng, [state_dim + 1, HIDDEN, HIDDEN, 1], device)
    zeros = lambda tree: tree_map(torch.zeros_like, tree)     # noqa: E731
    adam = lambda tree: {"m": zeros(tree), "v": zeros(tree)}  # noqa: E731
    return AgentState(actor, critic, tree_map(torch.clone, actor),
                      tree_map(torch.clone, critic), adam(actor),
                      adam(critic), 0)


def _adam_update(params, grads, opt, step: int, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
    m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, opt["m"], grads)
    v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g * g, opt["v"], grads)
    t = torch.tensor(step, dtype=torch.float32) + 1
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
    new = tree_map(
        lambda p, mm, vv: p - lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps),
        params, m, v)
    return new, {"m": m, "v": v}


def agent_update(agent: AgentState, batch: Dict[str, torch.Tensor],
                 baseline: float, gamma: float = 1.0,
                 actor_lr: float = 1e-4, critic_lr: float = 1e-3,
                 tau: float = 0.01) -> Tuple[AgentState, Dict]:
    """One DDPG update on a sampled batch.

    batch: dict of (B, ...) tensors on the agent's device: state, action,
    reward, next_state, done. Implements Eq. 2 (critic MSE) with target
    Eq. 3:  y = (r - b) + gamma * Q'(s', mu'(s'))        (gamma = 1, paper)
    """
    s, a = batch["state"], batch["action"]
    r, s2, done = batch["reward"], batch["next_state"], batch["done"]
    with torch.no_grad():
        a2 = actor_apply(agent.actor_tgt, s2)
        q2 = critic_apply(agent.critic_tgt, s2, a2)
        y = (r - baseline) + gamma * (1.0 - done) * q2

    def critic_loss(cp):
        q = critic_apply(cp, s, a)
        return torch.mean((y - q) ** 2)

    closs, cgrad = value_and_grad(critic_loss, agent.critic)
    with torch.no_grad():
        new_critic, new_copt = _adam_update(agent.critic, cgrad,
                                            agent.critic_opt, agent.step,
                                            critic_lr)

    def actor_loss(ap):
        return -torch.mean(critic_apply(new_critic, s, actor_apply(ap, s)))

    aloss, agrad = value_and_grad(actor_loss, agent.actor)
    with torch.no_grad():
        new_actor, new_aopt = _adam_update(agent.actor, agrad,
                                           agent.actor_opt, agent.step,
                                           actor_lr)
        soft = lambda tgt, src: tree_map(                     # noqa: E731
            lambda t, p: (1 - tau) * t + tau * p, tgt, src)
        new = AgentState(new_actor, new_critic,
                         soft(agent.actor_tgt, new_actor),
                         soft(agent.critic_tgt, new_critic),
                         new_aopt, new_copt, agent.step + 1)
    return new, {"critic_loss": closs, "actor_loss": aloss}


def truncated_normal_action(gen: torch.Generator, mu, sigma: float
                            ) -> torch.Tensor:
    """Eq. 4: a' ~ TN(mu, sigma^2) truncated to [ACTION_LO, ACTION_HI], by
    the inverse CDF of a uniform draw from ``gen`` (a CPU generator)
    between the bounds' CDF values, in float64; returns float32 on mu's
    device. ``z`` is clamped to the bounds, which the CDF's underflow far
    in a tail could otherwise leave."""
    mu = torch.as_tensor(mu, dtype=torch.float64)
    s = max(sigma, 1e-6)
    lo = (ACTION_LO - mu) / s
    hi = (ACTION_HI - mu) / s
    u = torch.rand(mu.shape, generator=gen, dtype=torch.float64).to(
        mu.device)
    plo, phi = torch.special.ndtr(lo), torch.special.ndtr(hi)
    z = torch.special.ndtri(plo + (phi - plo) * u)
    z = torch.minimum(torch.maximum(z, lo), hi)
    return (mu + sigma * z).to(torch.float32)


class ReplayBuffer:
    """Ring buffer (paper: capacity 500)."""

    def __init__(self, state_dim: int, capacity: int = 500):
        self.capacity = capacity
        self.n = 0
        self.i = 0
        self.state = np.zeros((capacity, state_dim), np.float32)
        self.action = np.zeros((capacity,), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.next_state = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)

    def add(self, s, a, r, s2, done):
        j = self.i
        self.state[j], self.action[j] = s, a
        self.reward[j], self.next_state[j], self.done[j] = r, s2, done
        self.i = (j + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)

    def sample(self, rng: np.random.RandomState, batch: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """``batch`` transitions drawn with replacement by ``rng`` (the
        reference's draw), as tensors on ``device`` (the card by
        default)."""
        device = resolve_device(device)
        idx = rng.randint(0, self.n, size=batch)
        return {k: torch.from_numpy(getattr(self, k)[idx]).to(device)
                for k in ("state", "action", "reward", "next_state", "done")}
