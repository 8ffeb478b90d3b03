"""The paper's pipeline in the port against the JAX package's, stage by
stage on shared numpy inputs at a small size (``tiny_cnn_config(width=0.2,
hw=32)``, ``PlantVillageSynthetic(n_per_class=12, hw=32)``): the synthetic
data, training, top-k evaluation, the stage-2 reward, the stage-5 and
stage-6 splits, ``DeploymentPlan.from_pipeline`` and ``describe``; then
one small ``run_paper_pipeline(device="cpu")`` end to end, whose saved plan
the reference loads and serves."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as rserving
from repro.core import pipeline as rp
from repro.core.collab.adaptive import AdaptivePolicy
from repro.core.fleet import FleetScenario
from repro.core.partition import profiles as rprof
from repro.core.partition import splitter as rsplit
from repro.core.partition.energy_model import MCU_ENERGY, EnergyPolicy
from repro.core.partition.latency_model import (
    cnn_input_bytes as r_input_bytes, cnn_layer_costs as r_costs,
    compacted_cnn_layer_costs as r_ccosts)
from repro.core.pruning.masks import cnn_masks_from_ratios as r_masks_from
from repro.data import synthetic as rsyn
from repro.models import cnn as rcnn
from repro_torch import serving as tserving
from repro_torch.core import pipeline as tp
from repro_torch.core.collab.protocol import CODEC_TX_SCALE
from repro_torch.core.partition import profiles as tprof
from repro_torch.core.partition import splitter as tsplit
from repro_torch.core.partition.latency_model import (
    cnn_input_bytes as t_input_bytes, cnn_layer_costs as t_costs,
    compacted_cnn_layer_costs as t_ccosts)
from repro_torch.data import synthetic as tsyn
from repro_torch.models import cnn as tcnn
from torch_parity import EPS32, fp32_tol, port_params, ref_tree, to_f32
from torch_parity import one_thread  # noqa: F401 (autouse)


def _cfgs():
    return (rcnn.tiny_cnn_config(num_classes=38, width=0.2, hw=32),
            tcnn.tiny_cnn_config(num_classes=38, width=0.2, hw=32))


def _params_np(cfg, seed=0):
    """He-normal weights and small random biases, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shp in tcnn.param_shapes(cfg).items():
        fan_in = int(np.prod(shp["w"][:-1]))
        out[name] = {"w": (rng.standard_normal(shp["w"], dtype=np.float32)
                           * np.float32(np.sqrt(2.0 / fan_in))),
                     "b": rng.standard_normal(shp["b"], dtype=np.float32)
                     * np.float32(0.05)}
    return out


def _masks_np(cfg, params, ratio=0.5):
    ratios = {i: ratio for i in tcnn.prunable_layers(cfg)}
    return tp.numpy_masks(tp.cnn_masks_from_ratios(port_params(params), cfg,
                                                   ratios))


@pytest.fixture(scope="module")
def data():
    """(reference dataset, port dataset): 456 images, 380 to train."""
    return (rsyn.PlantVillageSynthetic(n_per_class=12, hw=32),
            tsyn.PlantVillageSynthetic(n_per_class=12, hw=32))


def test_synthetic_data_is_the_reference_bit_for_bit(data):
    for c, i, seed, hw in ((0, 0, 0, 32), (5, 3, 1, 32), (37, 11, 0, 64),
                           (12, 2, 7, 224)):
        got, want = tsyn.make_image(c, i, seed, hw), rsyn.make_image(c, i,
                                                                     seed, hw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for seed in (0, 3):
        for g, w in zip(tsyn.stratified_split(12, 0.8, seed),
                        rsyn.stratified_split(12, 0.8, seed)):
            np.testing.assert_array_equal(g, w)
    dr, dt = data
    np.testing.assert_array_equal(dt.train_ids, dr.train_ids)
    np.testing.assert_array_equal(dt.test_ids, dr.test_ids)
    for got, want in ((dt.iter_train(32, epochs=2, seed=101),
                       dr.iter_train(32, epochs=2, seed=101)),
                      (dt.test_batches(64), dr.test_batches(64))):
        got, want = list(got), list(want)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])


@pytest.mark.parametrize("optimizer,masked", [("sgd", False),
                                              ("adamw", True)])
def test_train_cnn_matches_reference(data, optimizer, masked):
    """Two epochs of 11 steps from the same parameters (masked in the
    fine-tuning case): the losses and the trained parameters. The
    gradients sum over batch x pixels x channels in other orders (oneDNN
    against XLA), and AdamW's m / sqrt(v) magnifies the gap where a
    gradient is small: over 22 steps the parameters stay within 3e-5 of
    each leaf's largest entry (measured: 3.4e-6 with AdamW, 1.7e-7 with
    SGD) and the losses within 1e-6 relative, while one step more or
    less, a wrong learning rate or a missing mask moves them by percents."""
    cfg_r, cfg_t = _cfgs()
    params = _params_np(cfg_t)
    masks = _masks_np(cfg_t, params) if masked else None
    kw = dict(epochs=2, batch_size=32, lr=3e-3 if optimizer == "adamw"
              else 0.01, optimizer_name=optimizer)
    pr, hr = rp.train_cnn(ref_tree(params), cfg_r, data[0],
                          masks=({i: jnp.asarray(m) for i, m in masks.items()}
                                 if masks else None), **kw)
    pt, ht = tp.train_cnn(port_params(params), cfg_t, data[1], masks=masks,
                          device="cpu", **kw)
    np.testing.assert_allclose(ht, hr, rtol=1e-6)
    assert ht[1] < ht[0]
    for name in pr:
        for leaf in ("w", "b"):
            w = np.asarray(pr[name][leaf])
            g = to_f32(pt[name][leaf])
            assert pt[name][leaf].device.type == "cpu"
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=3e-5 * np.abs(w).max(),
                                       err_msg=f"{name}.{leaf}")


def test_evaluate_topk_matches_reference(data):
    """The same parameters and masks give the same top-1/3/5 accuracies:
    the logits agree to a few ulp and both rank them with ``np.argsort``
    on the host."""
    cfg_r, cfg_t = _cfgs()
    params = _params_np(cfg_t, seed=1)
    masks = _masks_np(cfg_t, params, 0.6)
    for m in (None, masks):
        want = rp.evaluate_topk(ref_tree(params), cfg_r, data[0],
                                masks=({i: jnp.asarray(v) for i, v in
                                        m.items()} if m else None))
        got = tp.evaluate_topk(port_params(params), cfg_t, data[1], masks=m,
                               device="cpu")
        assert got == want


def test_stage2_reward_matches_reference(data):
    """The reward of a ratio vector: top-1 on the reference's evaluation
    subset, masks from the ratios rounded to 3 places (the cache key),
    held to the reference's masks and ``cnn_apply`` on the same
    parameters; a repeated key comes from the cache."""
    cfg_r, cfg_t = _cfgs()
    params = _params_np(cfg_t, seed=2)
    players = tcnn.prunable_layers(cfg_t)
    evaluate = tp.reward_evaluator(port_params(params), cfg_t, data[1],
                                   device="cpu")
    dr = data[0]
    eval_ids = dr.test_ids[::max(len(dr.test_ids) // 256, 1)]
    batch = dr._batch(eval_ids)
    for actions in ([1.0] * 4, [0.31234, 0.8, 0.5, 0.1], [0.05, 0.05, 1.0,
                                                           0.7]):
        key = [round(a, 3) for a in actions]
        masks = r_masks_from(ref_tree(params), cfg_r, dict(zip(players, key)))
        logits = np.asarray(rcnn.cnn_apply(ref_tree(params), cfg_r,
                                           jnp.asarray(batch["image"]),
                                           masks=masks))
        want = float((logits.argmax(-1) == batch["label"]).mean())
        assert evaluate(actions) == want
    assert evaluate([0.3121, 0.8, 0.5, 0.1]) == evaluate([0.312, 0.8, 0.5,
                                                           0.1])


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_split_stages_match_reference(codec):
    """Stage 5 (greedy split on the masked costs) and stage 6 (on the
    compacted costs with the codec's wire discount), and the beyond-paper
    ``balanced_split`` and ``joint_two_stage``: the Eq. 5 tables, row for
    row, and the decisions are the reference's. Each table has N + 1 rows
    and its decision is the argmin."""
    cfg_r, cfg_t = _cfgs()
    params = _params_np(cfg_t)
    masks = _masks_np(cfg_t, params, 0.4)
    jm = {i: jnp.asarray(m) for i, m in masks.items()}
    n = len(cfg_t.layers)
    pairs = [
        (rsplit.greedy_split(r_costs(cfg_r, jm), rprof.PAPER_PROFILE,
                             r_input_bytes(cfg_r)),
         tsplit.greedy_split(t_costs(cfg_t, masks), tprof.PAPER_PROFILE,
                             t_input_bytes(cfg_t))),
        (rsplit.greedy_split(r_ccosts(cfg_r, jm), rprof.PAPER_PROFILE,
                             r_input_bytes(cfg_r),
                             tx_scale=CODEC_TX_SCALE[codec]),
         tsplit.greedy_split(t_ccosts(cfg_t, masks), tprof.PAPER_PROFILE,
                             t_input_bytes(cfg_t),
                             tx_scale=CODEC_TX_SCALE[codec])),
        (rsplit.balanced_split(r_ccosts(cfg_r, jm), rprof.PAPER_PROFILE,
                               r_input_bytes(cfg_r)),
         tsplit.balanced_split(t_ccosts(cfg_t, masks), tprof.PAPER_PROFILE,
                               t_input_bytes(cfg_t)))]
    for want, got in pairs:
        assert got.split_point == want.split_point
        assert got.table == want.table and len(got.table) == n + 1
    greedy = pairs[0][1]
    assert greedy.split_point == min(greedy.table,
                                     key=lambda r: r["T"])["split"]
    joint = [mod.joint_two_stage(lambda: [0.5] * 4,
                                 lambda r, c=costs: c, prof.PAPER_PROFILE,
                                 nbytes, mode="balanced")
             for mod, costs, prof, nbytes in (
                 (rsplit, r_costs(cfg_r, jm), rprof, r_input_bytes(cfg_r)),
                 (tsplit, t_costs(cfg_t, masks), tprof,
                  t_input_bytes(cfg_t)))]
    assert joint[1]["ratios"] == joint[0]["ratios"]
    assert joint[1]["split"].table == joint[0]["split"].table


def _results(deploy_codec="int8"):
    """A reference and a port ``PaperPipelineResult`` from the same pieces
    (parameters, masks, ratios, each package's stage-5 and stage-6
    splits); the search record is not read by ``from_pipeline``."""
    cfg_r, cfg_t = _cfgs()
    params = _params_np(cfg_t)
    masks = _masks_np(cfg_t, params, 0.4)
    jm = {i: jnp.asarray(m) for i, m in masks.items()}
    ratios = {i: 0.4 for i in masks}
    acc = {"top1": 0.5}
    out = []
    for mod, split_mod, prof, cfg, p, m, costs, ccosts, nbytes in (
            (rp, rsplit, rprof, cfg_r, ref_tree(params), jm, r_costs,
             r_ccosts, r_input_bytes),
            (tp, tsplit, tprof, cfg_t, port_params(params), masks, t_costs,
             t_ccosts, t_input_bytes)):
        split = split_mod.greedy_split(costs(cfg, m), prof.PAPER_PROFILE,
                                       nbytes(cfg))
        deploy = split_mod.greedy_split(
            ccosts(cfg, m), prof.PAPER_PROFILE, nbytes(cfg),
            tx_scale=CODEC_TX_SCALE[deploy_codec])
        out.append(mod.PaperPipelineResult(
            cfg, p, m, acc, acc, acc, ratios, None, split,
            prof.PAPER_PROFILE, deploy_split=deploy,
            deploy_codec=deploy_codec))
    return out


def test_from_pipeline_and_describe_match_reference():
    """``from_pipeline`` packages the same contract in both packages
    (compact: the stage-6 split; not compact: stage 5's, with channel
    packing; a codec override; the policy sections), so digests and the
    ``describe`` string are the reference's."""
    res_r, res_t = _results()
    variants = [
        ({}, {}),
        ({"compact": False}, {"compact": False}),
        ({"codec": "fp16"}, {"codec": "fp16"}),
        ({"quant": rserving.QuantPolicy(weight_bits=8)},
         {"quant": tserving.QuantPolicy(weight_bits=8)}),
        ({"batching": rserving.BatchingPolicy(max_batch=8, max_wait_ms=2.0),
          "faults": rserving.FaultPolicy(max_retries=2)},
         {"batching": tserving.BatchingPolicy(max_batch=8, max_wait_ms=2.0),
          "faults": tserving.FaultPolicy(max_retries=2)})]
    for kw_r, kw_t in variants:
        want = rserving.DeploymentPlan.from_pipeline(res_r, **kw_r)
        got = tserving.DeploymentPlan.from_pipeline(res_t, **kw_t)
        assert (got.split, got.compact, got.pack, got.codec) == \
            (want.split, want.compact, want.pack, want.codec)
        assert got.digest == want.digest
        assert got.describe() == want.describe()
    assert tserving.DeploymentPlan.from_pipeline(res_t).split == \
        res_t.deploy_split.split_point
    assert tserving.DeploymentPlan.from_pipeline(
        res_t, compact=False).split == res_t.split.split_point


def test_describe_shows_the_unported_sections_as_the_reference():
    """The ``adaptive`` and ``energy`` sections handed to the port as JSON
    become its policy objects, and the ``fleet`` section, once held as
    JSON and refused (the test keeps that name), is the port's
    ``FleetScenario``, given as the object or as its JSON; ``describe``
    and the digest of each are the reference's, and the fleet plan from
    the pipeline serves with the bare plan's bits."""
    res_r, res_t = _results("fp32")
    sections = {"adaptive": AdaptivePolicy(candidates=(3, 9)),
                "energy": EnergyPolicy(profile=MCU_ENERGY,
                                       energy_weight_s_per_j=0.25,
                                       battery_j=120.0),
                "fleet": FleetScenario(name="orchard", n_edges=40,
                                       n_cloudlets=2)}
    for name, sec in sections.items():
        want = rserving.DeploymentPlan.from_pipeline(res_r, **{name: sec})
        for given in (sec.to_json(), _port_section(name, sec)):
            got = tserving.DeploymentPlan.from_pipeline(res_t,
                                                        **{name: given})
            assert got.digest == want.digest
            assert got.describe() == want.describe(), name
    assert isinstance(got.fleet, tserving.FleetScenario)
    bare = tserving.DeploymentPlan.from_pipeline(res_t)
    image = np.random.default_rng(3).standard_normal(
        (1, *res_t.cfg.input_hw, 3), dtype=np.float32)
    with tserving.connect(bare, "local", device="cpu") as b, \
            tserving.connect(got, "local", device="cpu") as f:
        w, g = b.infer(image), f.infer(image)
    assert np.array_equal(g["logits"], w["logits"])
    assert g["tx_bytes"] == w["tx_bytes"]


def _port_section(name, sec):
    """The port's policy object for the reference's ``sec``."""
    cls = {"adaptive": tserving.AdaptivePolicy,
           "energy": tserving.EnergyPolicy,
           "fleet": tserving.FleetScenario}[name]
    return cls.from_json(sec.to_json())


@pytest.fixture(scope="module")
def tiny_run(data):
    """One small port pipeline on the CPU (the reference system test's
    recipe, fewer epochs and episodes), with its log lines."""
    _, cfg_t = _cfgs()
    lines = []
    res = tp.run_paper_pipeline(cfg_t, data[1], train_epochs=3,
                                finetune_epochs=1, episodes=6, warmup=2,
                                flops_budget=0.6, seed=0,
                                optimizer_name="adamw", lr=3e-3,
                                log=lines.append, device="cpu")
    return res, lines


def test_tiny_pipeline_runs_every_stage(tiny_run):
    """The six stages and their log lines in the reference's order; every
    ratio in the action range, the FLOPs kept within the budget (AMC's
    clipping keeps it reachable), one Eq. 5 row per split with the argmin
    chosen, compacted parameters whose shapes follow the masks."""
    res, lines = tiny_run
    stages = [ln for ln in lines if ln.startswith("[")]
    assert [s[:5] for s in stages] == [f"[{k}/6]" for k in range(1, 7)]
    assert sum(ln.startswith("epoch ") for ln in lines) == 3 + 1
    assert lines[-1].strip().startswith("DeploymentPlan[")
    n = len(res.cfg.layers)
    assert set(res.ratios) == set(tcnn.prunable_layers(res.cfg))
    assert all(0.05 <= r <= 1.0 for r in res.ratios.values())
    assert res.search.best_flops_kept <= 0.6 + 1e-9
    assert len(res.search.history) == 6
    for dec in (res.split, res.deploy_split):
        assert len(dec.table) == n + 1
        assert dec.split_point == min(dec.table, key=lambda r: r["T"])["split"]
    for k in ("acc_original", "acc_pruned", "acc_finetuned"):
        assert set(getattr(res, k)) == {"top1", "top3", "top5"}
    assert res.acc_original["top1"] > 3 / 38
    for i, m in res.masks.items():
        assert m.dtype == np.float32
        assert res.compact_params[f"l{i}"]["b"].shape[0] == int(m.sum())
    assert res.plan.split == res.deploy_split.split_point
    assert all(t.device.type == "cpu" for v in res.params.values()
               for t in v.values())


def test_tiny_pipeline_plan_loads_and_serves_in_the_reference(tiny_run,
                                                              tmp_path):
    """The plan the port's pipeline saves: the reference loads it with the
    same digest and ``describe``, and serves it to the port's logits
    within the fp32 tolerance, with equal wire bytes."""
    res, _ = tiny_run
    plan = tserving.DeploymentPlan.from_pipeline(res)
    assert plan.digest == res.plan.digest
    path = plan.save(str(tmp_path / "plan"))
    ref = rserving.DeploymentPlan.load(path)
    assert ref.digest == plan.digest
    assert ref.describe() == plan.describe()
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((1, 32, 32, 3), dtype=np.float32)
              for _ in range(2)]
    r_sess = rserving.connect(ref, backend="local")
    with tserving.connect(tserving.DeploymentPlan.load(path),
                          backend="local", device="cpu") as t_sess:
        for img in images:
            want, got = r_sess.infer(img), t_sess.infer(img)
            lw = np.asarray(want["logits"])
            assert got["tx_bytes"] == want["tx_bytes"]
            np.testing.assert_allclose(got["logits"], lw, rtol=0,
                                       atol=fp32_tol(lw))


def test_train_step_loss_is_the_cross_entropy():
    """``_xent`` is logsumexp minus the gold logit, averaged: held to a
    float64 evaluation."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 38)).astype(np.float32) * 4
    labels = rng.integers(0, 38, 6)
    want = np.mean(np.log(np.exp(logits.astype(np.float64)).sum(-1))
                   - logits[np.arange(6), labels])
    got = tp._xent(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(float(got) - want) <= 64 * EPS32 * abs(want)
