"""The paper's end-to-end pipeline, the port of the JAX package's
``core/pipeline.py``:

  train CNN -> DDPG pruning search -> fine-tune -> greedy split ->
  compact -> deploy.

Every stage is the real algorithm from ``core/``, with the reference's
stages, arguments and log lines, on one device (the card unless the
caller names another). Training runs autograd on ``models.cnn.cnn_apply``
(library convolutions and GEMMs: the reference trains with its Pallas
dispatch off, and no module has a custom gradient), and training and the
reward evaluations run inside ``device.exact_fp32()``, so cuDNN keeps
full fp32 where it would take TF32. Accuracies rank the logits on the host
with ``np.argsort``, as the reference does, so ties break the same way.

Parameters start from the port's ``init_cnn_params(seed, cfg)`` (numpy
draws); the reference draws from ``jax.random``, so the two pipelines
differ in their draws, never in their arithmetic.

The deployment stage materializes the pruning masks via ``compact_params``,
re-prices the per-layer costs at the compacted shapes with the chosen
feature codec's wire discount, re-picks the split point on those costs,
and packages the deployment contract as a ``DeploymentPlan``
(``result.plan``; ``DeploymentPlan.from_pipeline(result)`` packages the
same pieces with other sections) — save it with ``plan.save(dir)`` and
serve it with ``serving.connect(plan, backend="local"|"socket"|
"streaming")``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CNNConfig
from repro_torch.core.collab.protocol import CODEC_TX_SCALE
from repro_torch.core.partition.latency_model import (
    cnn_input_bytes, cnn_layer_costs, compacted_cnn_layer_costs)
from repro_torch.core.partition.profiles import PAPER_PROFILE, TwoTierProfile
from repro_torch.core.partition.splitter import SplitDecision, greedy_split
from repro_torch.core.pruning.amc_env import PruningEnv, cnn_layer_descs
from repro_torch.core.pruning.masks import cnn_masks_from_ratios
from repro_torch.core.pruning.policy import (SearchResult,
                                             search_pruning_policy)
from repro_torch.data.synthetic import PlantVillageSynthetic
from repro_torch.device import DeviceLike, exact_fp32, resolve_device
from repro_torch.models.cnn import (Params, cnn_apply, compact_params,
                                    init_cnn_params, masks_to,
                                    prunable_layers)
from repro_torch.optim import make_optimizer, step_lr, value_and_grad
from repro_torch.optim.optimizers import tree_map
from repro_torch.serving.plan import DeploymentPlan


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


def params_to(params: Params, device: torch.device) -> Params:
    return tree_map(lambda t: t.to(device), params)


def _images(x, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def make_train_step(cfg: CNNConfig, optimizer, masks=None,
                    device: DeviceLike = None):
    """-> ``step(params, opt_state, batch) -> (params, opt_state, loss)``
    on ``device``: the cross-entropy's gradient by autograd, then one
    optimizer update. ``params`` and the optimizer state live on the
    device; ``batch`` is the dataset's dict of numpy arrays."""
    device = resolve_device(device)
    tmasks = masks_to(masks, device)

    def step(params, opt_state, batch):
        x = _images(batch["image"], device)
        y = torch.from_numpy(np.asarray(batch["label"], np.int64)).to(device)
        with exact_fp32():
            loss, grads = value_and_grad(
                lambda p: _xent(cnn_apply(p, cfg, x, masks=tmasks), y),
                params)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss
    return step


def train_cnn(params, cfg: CNNConfig, data: PlantVillageSynthetic,
              epochs: int = 3, batch_size: int = 32, lr: float = 0.01,
              masks=None, log: Optional[Callable] = None,
              optimizer_name: str = "sgd", device: DeviceLike = None):
    """Default: SGD momentum 0.9 + StepLR(0.1/20) — the paper's §4.1 recipe.
    ``optimizer_name="adamw"`` is the reduced-scale alternative. Returns
    (params on ``device``, the mean loss of each epoch)."""
    device = resolve_device(device)
    steps_per_epoch = max(len(data.train_ids) // batch_size, 1)
    if optimizer_name == "adamw":
        optimizer = make_optimizer("adamw", step_lr(lr, 0.1, 20,
                                                    steps_per_epoch))
    else:
        optimizer = make_optimizer(
            "sgd", step_lr(lr, 0.1, 20, steps_per_epoch), momentum=0.9)
    params = params_to(params, device)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer, masks, device=device)
    history = []
    for ep in range(epochs):
        losses = []
        for batch in data.iter_train(batch_size, epochs=1, seed=100 + ep):
            params, opt_state, loss = step_fn(params, opt_state, batch)
            losses.append(float(loss))
        history.append(float(np.mean(losses)))
        if log:
            log(f"epoch {ep}: loss {history[-1]:.4f}")
    return params, history


def evaluate_topk(params, cfg: CNNConfig, data: PlantVillageSynthetic,
                  ks: Tuple[int, ...] = (1, 3, 5), masks=None,
                  batch_size: int = 64,
                  device: DeviceLike = None) -> Dict[str, float]:
    """Top-k accuracy over the test split on ``device``; the logits are
    ranked on the host."""
    device = resolve_device(device)
    tparams, tmasks = params_to(params, device), masks_to(masks, device)
    hits = {k: 0 for k in ks}
    n = 0
    for batch in data.test_batches(batch_size):
        with torch.inference_mode(), exact_fp32():
            logits = cnn_apply(tparams, cfg, _images(batch["image"], device),
                               masks=tmasks).cpu().numpy()
        order = np.argsort(-logits, axis=-1)
        for k in ks:
            hits[k] += (order[:, :k] == batch["label"][:, None]).any(1).sum()
        n += len(batch["label"])
    return {f"top{k}": hits[k] / n for k in ks}


def reward_evaluator(params, cfg: CNNConfig, data: PlantVillageSynthetic,
                     device: DeviceLike = None
                     ) -> Callable[[List[float]], float]:
    """Stage 2's reward: top-1 accuracy of the masked model on a fixed
    subset of the test split (every ``len // 256``-th image), for one
    preserve ratio per prunable layer. Results are cached on the ratios
    rounded to 3 places, as in the reference."""
    device = resolve_device(device)
    tparams = params_to(params, device)
    players = prunable_layers(cfg)
    eval_ids = data.test_ids[::max(len(data.test_ids) // 256, 1)]
    eval_batch = data._batch(eval_ids)
    x = _images(eval_batch["image"], device)

    @functools.lru_cache(maxsize=512)
    def _acc_for(ratio_key) -> float:
        masks = cnn_masks_from_ratios(tparams, cfg,
                                      dict(zip(players, ratio_key)))
        with torch.inference_mode(), exact_fp32():
            logits = cnn_apply(tparams, cfg, x, masks=masks).cpu().numpy()
        return float((logits.argmax(-1) == eval_batch["label"]).mean())

    def evaluate(actions: List[float]) -> float:
        return _acc_for(tuple(round(a, 3) for a in actions))
    return evaluate


def numpy_masks(masks) -> Dict[int, np.ndarray]:
    return {int(i): m.detach().cpu().numpy() for i, m in masks.items()}


@dataclass
class PaperPipelineResult:
    cfg: CNNConfig
    params: Dict
    masks: Dict
    acc_original: Dict[str, float]
    acc_pruned: Dict[str, float]
    acc_finetuned: Dict[str, float]
    ratios: Dict[int, float]
    search: SearchResult
    split: SplitDecision
    profile: TwoTierProfile
    # deployment artifacts (compacted fast path)
    compact_params: Optional[Dict] = None
    compact_cfg: Optional[CNNConfig] = None
    deploy_split: Optional[SplitDecision] = None
    deploy_codec: str = "fp32"
    # the deployment contract: save with plan.save(dir), serve with
    # serving.connect(plan, backend=...)
    plan: Optional[DeploymentPlan] = None


def run_paper_pipeline(cfg: CNNConfig, data: PlantVillageSynthetic,
                       train_epochs: int = 4, finetune_epochs: int = 2,
                       episodes: int = 40, warmup: int = 10,
                       flops_budget: float = 0.5,
                       profile: TwoTierProfile = PAPER_PROFILE,
                       seed: int = 0,
                       log: Optional[Callable] = None,
                       optimizer_name: str = "sgd", lr: float = 0.01,
                       deploy_codec: str = "fp32",
                       device: DeviceLike = None) -> PaperPipelineResult:
    """The six stages on ``device`` (the card unless the caller names
    another). The result's parameters live on the device and its masks
    are numpy arrays."""
    device = resolve_device(device)
    log = log or (lambda s: None)
    params = init_cnn_params(seed, cfg)

    log("[1/6] train original model")
    params, _ = train_cnn(params, cfg, data, epochs=train_epochs, log=log,
                          lr=lr, optimizer_name=optimizer_name,
                          device=device)
    acc0 = evaluate_topk(params, cfg, data, device=device)
    log(f"    original acc: {acc0}")

    log("[2/6] DDPG pruning search (AMC, Eq. 1-4)")
    players = prunable_layers(cfg)
    env = PruningEnv(cnn_layer_descs(cfg),
                     reward_evaluator(params, cfg, data, device=device),
                     flops_budget=flops_budget)
    search = search_pruning_policy(env, episodes=episodes, warmup=warmup,
                                   seed=seed, log=log, device=device)
    ratios = dict(zip(players, search.best_ratios))
    log(f"    best ratios: { {k: round(v, 3) for k, v in ratios.items()} } "
        f"flops_kept={search.best_flops_kept:.3f}")

    log("[3/6] evaluate pruned model")
    masks = numpy_masks(cnn_masks_from_ratios(params, cfg, ratios))
    acc_pruned = evaluate_topk(params, cfg, data, masks=masks, device=device)
    log(f"    pruned acc: {acc_pruned}")

    log("[4/6] fine-tune pruned model (SGD m=0.9, StepLR)")
    ft_params, _ = train_cnn(params, cfg, data, epochs=finetune_epochs,
                             masks=masks, log=log, lr=lr * 0.3,
                             optimizer_name=optimizer_name, device=device)
    acc_ft = evaluate_topk(ft_params, cfg, data, masks=masks, device=device)
    log(f"    fine-tuned acc: {acc_ft}")

    log("[5/6] greedy split search (Algorithm 1 lines 20-27)")
    costs = cnn_layer_costs(cfg, masks)
    split = greedy_split(costs, profile, cnn_input_bytes(cfg))
    log(f"    optimal split c={split.split_point} "
        f"T={split.latency['T'] * 1e3:.2f} ms "
        f"(T_D={split.latency['T_D'] * 1e3:.2f} "
        f"T_TX={split.latency['T_TX'] * 1e3:.2f} "
        f"T_S={split.latency['T_S'] * 1e3:.2f})")

    log("[6/6] compact deployment + re-priced split on compacted shapes")
    cparams, ccfg = compact_params(ft_params, cfg, masks)
    dcosts = compacted_cnn_layer_costs(cfg, masks)
    deploy = greedy_split(dcosts, profile, cnn_input_bytes(cfg),
                          tx_scale=CODEC_TX_SCALE[deploy_codec])
    log(f"    deploy split c={deploy.split_point} codec={deploy_codec} "
        f"T={deploy.latency['T'] * 1e3:.2f} ms "
        f"tx={deploy.latency['tx_bytes'] / 1024:.1f} KB")
    plan = DeploymentPlan.from_args(ft_params, cfg, deploy.split_point,
                                    masks=masks, compact=bool(masks),
                                    codec=deploy_codec, profile=profile)
    log(f"    {plan.describe()}")
    return PaperPipelineResult(cfg, ft_params, masks, acc0, acc_pruned,
                               acc_ft, ratios, search, split, profile,
                               compact_params=cparams, compact_cfg=ccfg,
                               deploy_split=deploy,
                               deploy_codec=deploy_codec, plan=plan)
