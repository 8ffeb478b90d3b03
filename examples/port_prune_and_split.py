"""The paper's technique on an assigned transformer, on the PyTorch port
(the twin of ``examples/prune_and_split.py``): DDPG structured pruning
(heads / FFN channels / experts / SSD heads) of the smoke-scale model,
the greedy and balanced layer splits of the full config for two-tier
deployment, priced by ``transformer_layer_costs`` under a tier-B H100
profile (``h100_edge_cloud`` by default: an 8-card node at the edge site,
a 256-card cluster behind a 200 Gb/s uplink), and the paper CNN's
``DeploymentPlan`` saved, reloaded and served. It runs on the CUDA card
unless ``--device cpu`` asks for the CPU.

    PYTHONPATH=src python examples/port_prune_and_split.py \\
        --arch mixtral-8x7b [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch import serving
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.partition.latency_model import transformer_layer_costs
from repro_torch.core.partition.profiles import PROFILES
from repro_torch.core.partition.splitter import balanced_split, greedy_split
from repro_torch.core.pruning.amc_env import (PruningEnv,
                                              transformer_layer_descs)
from repro_torch.core.pruning.masks import (cnn_masks_from_ratios,
                                            mask_sparsity,
                                            transformer_masks_from_ratios,
                                            transformer_prunable_units)
from repro_torch.core.pruning.policy import search_pruning_policy
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.models.cnn import (init_cnn_params, prunable_layers,
                                    tiny_cnn_config)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mixtral-8x7b")
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--budget", type=float, default=0.6)
    ap.add_argument("--profile", choices=list(PROFILES),
                    default="h100_edge_cloud")
    ap.add_argument("--export-plan", default=None, metavar="DIR",
                    help="directory for the CNN DeploymentPlan artifact "
                         "demo (default: a temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1) DDPG pruning search on the smoke-scale model (the policy and the
    #    environment are size-agnostic)
    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    params = tr.init_params(cfg, 0, device=dev)
    units = transformer_prunable_units(cfg)
    descs = transformer_layer_descs(cfg, seq_len=64)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).to(dev)
    batch = {"tokens": tok, "labels": tok}
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.vision_tokens, cfg.d_model), dtype=np.float32)).to(dev)
    if cfg.embeds_input:
        batch = {"embeds": torch.from_numpy(rng.standard_normal(
            (4, 64, cfg.d_model), dtype=np.float32)).to(dev), "labels": tok}
    with torch.no_grad():
        base_loss = float(tr.loss_fn(params, cfg, batch)[0])

    def evaluate(ratios):
        masks = transformer_masks_from_ratios(params, cfg, list(ratios))
        with torch.no_grad():
            loss = float(tr.loss_fn(params, cfg, batch, masks=masks)[0])
        return float(np.exp(base_loss - loss))     # >1 if better than dense

    env = PruningEnv(descs, evaluate, flops_budget=args.budget)
    res = search_pruning_policy(env, episodes=args.episodes, warmup=2,
                                log=lambda s: print("  ", s), device=dev)
    print(f"\nbest reward {res.best_reward:.4f} "
          f"flops kept {res.best_flops_kept:.2f}")
    masks = transformer_masks_from_ratios(params, cfg, res.best_ratios)
    print(f"mask sparsity: {mask_sparsity(masks):.2%} of structured units "
          f"removed across {len(units)} (layer, axis) groups")

    # 2) greedy split of the FULL config under a two-tier H100 profile
    full = get_config(args.arch)
    profile = PROFILES[args.profile]
    costs = transformer_layer_costs(full, seq_len=4096)
    inp_bytes = 4096 * full.d_model * 2
    g = greedy_split(costs, profile, inp_bytes)
    b = balanced_split(costs, profile, inp_bytes)
    print(f"\nfull {args.arch}: {full.num_layers} layers, "
          f"profile={args.profile}")
    print(f"  greedy   split c={g.split_point:3d}  "
          f"T={g.latency['T'] * 1e3:.3f} ms "
          f"(TD {g.latency['T_D'] * 1e3:.3f} TX {g.latency['T_TX'] * 1e3:.3f} "
          f"TS {g.latency['T_S'] * 1e3:.3f})")
    print(f"  balanced split c={b.split_point:3d}  "
          f"bottleneck={max(b.latency['T_D'], b.latency['T_TX'], b.latency['T_S']) * 1e3:.3f} ms"
          f" (steady-state pipelined serving, beyond-paper)")

    # 3) the unified deployment artifact (paper CNN path): the whole
    #    contract (model, masks, split, codec, link) saved as one
    #    DeploymentPlan and re-served with no pipeline objects in scope
    ccfg = tiny_cnn_config(num_classes=38, hw=32)
    cparams = init_cnn_params(0, ccfg)
    cmasks = cnn_masks_from_ratios(cparams, ccfg,
                                   {i: 0.5 for i in prunable_layers(ccfg)})
    plan = serving.DeploymentPlan.from_args(cparams, ccfg, None,
                                            masks=cmasks, compact=True,
                                            codec="int8")
    out_dir = args.export_plan or tempfile.mkdtemp(prefix="deploy_plan_")
    plan.save(out_dir)
    reloaded = serving.DeploymentPlan.load(out_dir)
    with serving.connect(reloaded, backend="local", device=dev) as sess:
        out = sess.infer(np.zeros((1, 32, 32, 3), np.float32))
    print(f"\ndeployment artifact: {plan.describe()}")
    print(f"  exported to {out_dir}/, reloaded (digest match: "
          f"{reloaded.digest == plan.digest}), served one request "
          f"T={out['t_total'] * 1e3:.2f} ms, tx {out['tx_bytes']} B")
    return {"search": res, "greedy": g, "balanced": b,
            "digest_match": reloaded.digest == plan.digest}


if __name__ == "__main__":
    main()
