"""The port's pruning search against the JAX package's: the AMC
environment (``amc_env``), the DDPG agent's update, replay draws and
exploration noise (``ddpg``), and the search loop (``policy``), on shared
numpy inputs. The two agents draw from different generators, so the
search is held to the reference test's thresholds, not to its draws."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.configs.qwen2_7b import smoke_config as r_qwen_smoke
from repro.core.pruning import amc_env as renv
from repro.core.pruning import ddpg as rd
from repro.models import cnn as rcnn
from repro_torch.configs.qwen2_7b import smoke_config as t_qwen_smoke
from repro_torch.core.pruning import amc_env as tenv
from repro_torch.core.pruning import ddpg as td
from repro_torch.core.pruning.policy import search_pruning_policy
from repro_torch.models import cnn as tcnn
from torch_parity import EPS32, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)

CNN_CONFIGS = {"tiny": (lambda m: m.tiny_cnn_config(num_classes=38,
                                                      width=0.2, hw=32)),
               "alexnet": (lambda m: m.alexnet_config(38))}


def _fields(descs):
    return [tuple(vars(d).values()) for d in descs]


@pytest.mark.parametrize("name", sorted(CNN_CONFIGS))
def test_pruning_env_episode_matches_reference(name):
    """The environment is numpy code, copied: the layer descriptors, every
    state, the clipped actions, the FLOPs kept and the next states of one
    shared raw-action sequence (values below the floor, above 1 and above
    the budget's clip) are equal to the reference's, bit for bit."""
    descs_r = renv.cnn_layer_descs(CNN_CONFIGS[name](rcnn))
    descs_t = tenv.cnn_layer_descs(CNN_CONFIGS[name](tcnn))
    assert _fields(descs_t) == _fields(descs_r)
    raw = [0.02, 1.3, 0.9, 0.55, 0.97, 0.3, 0.8][:len(descs_r)]
    recs = []
    for mod, descs in ((renv, descs_r), (tenv, descs_t)):
        env = mod.PruningEnv(descs, lambda a: float(np.mean(a)) - 0.1,
                             flops_budget=0.4)
        recs.append(env.run_episode(lambda s, i: raw[i]))
    want, got = recs
    assert got["actions"] == want["actions"]
    assert got["reward"] == want["reward"]
    assert got["flops_kept"] == want["flops_kept"] <= 0.4 + 1e-12
    for key in ("states", "next_states"):
        assert len(got[key]) == len(want[key]) == len(descs_r)
        for g, w in zip(got[key], want[key]):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_transformer_layer_descs_match_reference():
    cfg_r = r_qwen_smoke().replace(dtype="float32")
    cfg_t = t_qwen_smoke().replace(dtype="float32")
    want = renv.transformer_layer_descs(cfg_r, seq_len=64)
    got = tenv.transformer_layer_descs(cfg_t, seq_len=64)
    assert got and _fields(got) == _fields(want)


def _mlp_np(rng, sizes):
    return [{"w": (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)
                   ).astype(np.float32),
             "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])]


def _agent_np(seed=0):
    """Agent arrays: actor and critic, targets a step away from them, and
    Adam moments as a few updates leave them (v well above zero, so
    m / sqrt(v) is well conditioned), at step 3."""
    rng = np.random.default_rng(seed)
    nets = [_mlp_np(rng, [11, 300, 300, 1]), _mlp_np(rng, [12, 300, 300, 1])]
    tgts = [[{k: a + (0.01 * rng.standard_normal(a.shape)).astype(np.float32)
              for k, a in lyr.items()} for lyr in net] for net in nets]
    opts = [{"m": [{k: (1e-2 * rng.standard_normal(a.shape)
                        ).astype(np.float32) for k, a in lyr.items()}
                   for lyr in net],
             "v": [{k: rng.uniform(1e-4, 1e-3, a.shape).astype(np.float32)
                    for k, a in lyr.items()} for lyr in net]}
            for net in nets]
    return nets, tgts, opts


def _batch_np(seed=1, n=32):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"state": rng.uniform(0, 1, (n, 11)).astype(f),
            "action": rng.uniform(0.05, 1.0, n).astype(f),
            "reward": rng.uniform(0, 1, n).astype(f),
            "next_state": rng.uniform(0, 1, (n, 11)).astype(f),
            "done": (rng.uniform(0, 1, n) < 0.2).astype(f)}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as(v, fn) for v in tree]
    return fn(tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [to_f32(tree)]


def test_agent_update_matches_reference():
    """One DDPG update from the same agent arrays and batch: the target
    from the target nets, the critic's Adam step, the actor's step against
    the new critic, the soft target updates. Gradients are sums over the
    300 hidden units and the batch of 32 taken in other orders (autograd
    against XLA), each off by at most (300 + 32)·eps of its terms, so every
    array agrees to (300 + 32)·eps of its largest entry (measured: under
    1e-6) and each loss to 1e-5 relative; a wrong order of the steps (the
    actor against the old critic), a missing bias correction or a gradient
    reaching the critic from the actor's loss moves them by far more."""
    nets, tgts, opts = _agent_np()
    ref = rd.AgentState(*_as(nets, jnp.asarray), *_as(tgts, jnp.asarray),
                        *_as(opts, jnp.asarray), jnp.int32(3))
    port = td.AgentState(*_as(nets, torch.from_numpy),
                         *_as(tgts, torch.from_numpy),
                         *_as(opts, torch.from_numpy), 3)
    batch = _batch_np()
    new_r, met_r = rd.agent_update(ref, _as(batch, jnp.asarray), 0.3)
    new_t, met_t = td.agent_update(port, _as(batch, torch.from_numpy), 0.3)
    assert new_t.step == int(new_r.step) == 4
    for name in ("actor", "critic", "actor_tgt", "critic_tgt", "actor_opt",
                 "critic_opt"):
        got, want = _flat(getattr(new_t, name)), _flat(getattr(new_r, name))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=(300 + 32) * EPS32 * np.abs(w).max(),
                err_msg=name)
    moved = _flat(new_t.actor)[0] - nets[0][0]["w"]
    assert np.abs(moved).max() > 0
    for key in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(float(met_t[key]), float(met_r[key]),
                                   rtol=1e-5)


def test_replay_sample_draws_the_reference_indices():
    """The same transitions and the same ``RandomState`` give the same
    sampled rows: ``rng.randint(0, n, batch)`` as in the reference."""
    bufs = [rd.ReplayBuffer(11, capacity=50), td.ReplayBuffer(11, capacity=50)]
    rng = np.random.default_rng(4)
    for i in range(73):                      # wraps the ring once
        tr = (rng.uniform(0, 1, 11).astype(np.float32), 0.05 + i / 100,
              rng.uniform(), rng.uniform(0, 1, 11).astype(np.float32),
              float(i % 7 == 6))
        for b in bufs:
            b.add(*tr)
    want = bufs[0].sample(np.random.RandomState(9), 40)
    got = bufs[1].sample(np.random.RandomState(9), 40, device="cpu")
    for key in want:
        assert got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


@pytest.mark.parametrize("mu,sigma", [(0.5, 0.5), (0.1, 0.2), (0.97, 0.1),
                                      (0.5, 0.02), (0.06, 1e-7)])
def test_truncated_normal_noise_bounds_and_moments(mu, sigma):
    """Eq. 4's noise by the inverse CDF: every draw in [0.05, 1], and at
    n = 200,000 the sample mean and variance within 6 standard errors of
    ``scipy.stats.truncnorm``'s (the variance's standard error from the
    fourth central moment). Below sigma = 1e-6 the bounds keep the
    reference's ``max(sigma, 1e-6)``: z ~ TN(lo, hi) at that scale, times
    sigma."""
    gen = torch.Generator().manual_seed(0)
    n = 200_000
    a = td.truncated_normal_action(gen, torch.full((n,), mu), sigma)
    assert a.dtype == torch.float32 and a.shape == (n,)
    a = a.double().numpy()
    assert a.min() >= np.float32(td.ACTION_LO) and a.max() <= 1.0
    s = max(sigma, 1e-6)
    dist = scipy.stats.truncnorm((td.ACTION_LO - mu) / s,
                                 (td.ACTION_HI - mu) / s, loc=mu, scale=sigma)
    mean, var = dist.mean(), dist.var()
    m4 = dist.expect(lambda x: (x - mean) ** 4)
    assert abs(a.mean() - mean) <= 6 * np.sqrt(var / n) + 1e-7
    assert abs(a.var() - var) <= 6 * np.sqrt(max(m4 - var ** 2, 0) / n) + 1e-7
    # the reference's draws lie in the same bounds
    r = rd.truncated_normal_action(jax.random.PRNGKey(0),
                                   jnp.full((256,), mu), sigma)
    assert float(r.min()) >= np.float32(rd.ACTION_LO)


def test_policy_search_finds_flops_heavy_layer():
    """Port copy of the reference's ``tests/test_pruning.py`` test, same
    thresholds: accuracy depends only on keeping layer 0, so the search
    keeps layer 0 and prunes the rest."""
    descs = [tenv.LayerDesc(i, 32, 32, 4, 4, 1, 3, 1e8, in_coupled=False)
             for i in range(4)]

    def evaluate(ratios):
        return float(ratios[0]) - 0.1 * float(np.mean(ratios[1:]))

    env = tenv.PruningEnv(descs, evaluate, flops_budget=0.5)
    res = search_pruning_policy(env, episodes=60, warmup=10, seed=0,
                                device="cpu")
    assert res.best_reward > 0.55
    assert res.best_ratios[0] > np.mean(res.best_ratios[1:])
    assert res.best_flops_kept <= 0.75
    assert len(res.history) == 60
    sig = [h["sigma"] for h in res.history]
    assert sig[:10] == [0.5] * 10
    assert sig[-1] == pytest.approx(max(0.5 * 0.97 ** 50, 0.02), rel=1e-12)


def test_ddpg_update_learns_reward_signal():
    """Port copy of the reference's test: the critic learns a reward that
    prefers high actions and the actor follows."""
    agent = td.init_agent(0, 11, device="cpu")
    rng = np.random.RandomState(0)
    buf = td.ReplayBuffer(11, capacity=500)
    for _ in range(300):
        s = rng.rand(11).astype(np.float32)
        a = rng.uniform(0.05, 1.0)
        buf.add(s, a, a, np.zeros(11, np.float32), 1.0)
    s_test = torch.from_numpy(rng.rand(64, 11).astype(np.float32))
    a0 = float(td.actor_apply(agent.actor, s_test).mean())
    for _ in range(200):
        agent, metrics = td.agent_update(
            agent, buf.sample(rng, 64, device="cpu"), baseline=0.5)
    a1 = float(td.actor_apply(agent.actor, s_test).mean())
    assert a1 > a0 + 0.1, (a0, a1)
    assert np.isfinite(float(metrics["critic_loss"]))


def test_init_agent_is_the_same_on_every_device_for_a_seed():
    a, b = td.init_agent(5, 11, device="cpu"), td.init_agent(5, 11,
                                                              device="cpu")
    for x, y in zip(_flat(list(a[:4])), _flat(list(b[:4]))):
        np.testing.assert_array_equal(x, y)
    assert [lyr["w"].shape for lyr in a.actor] == [(11, 300), (300, 300),
                                                   (300, 1)]
    assert a.critic[0]["w"].shape == (12, 300)
