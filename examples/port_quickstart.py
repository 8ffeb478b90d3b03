"""Quickstart on the PyTorch port: the paper's two-stage optimization, the
twin of ``examples/quickstart.py``. It runs on the CUDA card unless
``--device cpu`` asks for the CPU.

    PYTHONPATH=src python examples/port_quickstart.py [--device cpu]

1. builds a reduced AlexNet-family CNN + synthetic PlantVillage-38,
2. trains it briefly,
3. runs a short DDPG pruning search (AMC, paper §3.2),
4. greedy split-point selection (Algorithm 1) under the paper's
   i7-edge / 3090-server / 50 Mbps-Wi-Fi profile,
5. deploys the resulting DeploymentPlan through repro_torch.serving and
   prints the Eq. 5 breakdown.
"""
import argparse

import numpy as np

from repro_torch import serving
from repro_torch.core.pipeline import run_paper_pipeline
from repro_torch.data.synthetic import PlantVillageSynthetic
from repro_torch.models.cnn import tiny_cnn_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    print("== quickstart: prune + split a plant-disease CNN ==")
    cfg = tiny_cnn_config(num_classes=38, width=0.25, hw=32)
    data = PlantVillageSynthetic(n_per_class=10, hw=32)
    res = run_paper_pipeline(cfg, data, train_epochs=5, finetune_epochs=3,
                             episodes=24, warmup=6, flops_budget=0.7,
                             optimizer_name="adamw", lr=3e-3,
                             log=lambda s: print("  ", s),
                             device=args.device)
    print(f"\noriginal  acc: {res.acc_original}")
    print(f"pruned    acc: {res.acc_pruned}")
    print(f"fine-tuned acc: {res.acc_finetuned}")
    print(f"pruning ratios: { {k: round(v, 2) for k, v in res.ratios.items()} }")
    print(f"optimal split: c={res.split.split_point} "
          f"T={res.split.latency['T'] * 1e3:.2f} ms "
          f"(T_D {res.split.latency['T_D'] * 1e3:.2f} + "
          f"T_TX {res.split.latency['T_TX'] * 1e3:.2f} + "
          f"T_S {res.split.latency['T_S'] * 1e3:.2f})")

    print("\n== deploy the plan and serve one image ==")
    print(res.plan.describe())
    with serving.connect(res.plan, backend="local",
                         device=args.device) as sess:
        img = data._batch(data.test_ids[:1])["image"]
        out = sess.infer(img)
    print(f"predicted class: {int(np.argmax(out['logits']))} "
          f"(true {int(data.test_ids[0][0])})")
    print(f"T = {out['t_total'] * 1e3:.2f} ms  "
          f"[edge {out['t_edge'] * 1e3:.2f} | net+cloud "
          f"{out['t_upstream'] * 1e3:.2f} ({out['tx_bytes']} B)]")
    return res, out


if __name__ == "__main__":
    main()
