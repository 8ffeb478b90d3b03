"""Train a reduced assigned-architecture transformer end to end on the
PyTorch port (the twin of ``examples/train_transformer.py``): the sharded
train step on the host mesh (``launch.mesh.host_mesh``: a (1, n) mesh over
this host's process group, started here as one process), AdamW with a
cosine schedule, the loss curve, and a checkpoint through
``checkpoint.store`` that the JAX package restores too. It runs on the
CUDA card (NCCL) unless ``--device cpu`` asks for the CPU (gloo).

    PYTHONPATH=src python examples/port_train_transformer.py \\
        --arch qwen2-7b --steps 100 [--device cpu]
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.sharding import specs as sh


def synth_batch(cfg, seed: int, B: int, S: int):
    """Markov-chain synthetic tokens (learnable bigram structure): a random
    start, then steps of 1..16 modulo the vocabulary; labels are the next
    tokens, -1 past the end. A VLM's vision embeddings and an audio
    config's frame embeddings are normals. numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, cfg.vocab_size, (B, 1))
    steps = rng.integers(1, 17, (B, S - 1))
    tok = np.concatenate(
        [start, (start + np.cumsum(steps, 1)) % cfg.vocab_size], 1)
    batch = {"tokens": tok.astype(np.int32),
             "labels": np.concatenate(
                 [tok[:, 1:], -np.ones((B, 1), np.int64)], 1)
             .astype(np.int32)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model), dtype=np.float32)
    if cfg.embeds_input:
        batch = {"embeds": rng.standard_normal((B, S, cfg.d_model),
                                               dtype=np.float32),
                 "labels": tok.astype(np.int32)}
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt", "train_transformer"))
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    with host_mesh(args.device) as mesh:
        params = tr.init_params(cfg, 0, device=mesh.device_type)
        n = tr.param_count(params)
        print(f"{args.arch} (reduced): {n / 1e6:.2f}M params, "
              f"{cfg.num_layers}L d{cfg.d_model}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
              f"{mesh.device_type}")
        opt = adamw(cosine_warmup(args.lr, warmup=min(10, args.steps // 5),
                                  total=args.steps))
        pspecs = sh.param_specs(params, cfg, mesh)
        state = opt.init(params)
        state = sh.distribute(state, sh.opt_state_specs(state, pspecs), mesh)
        params = sh.distribute(params, pspecs, mesh)
        step = make_train_step(cfg, opt, device=mesh.device_type, mesh=mesh)
        losses = []
        t0 = time.time()
        for i in range(args.steps):
            batch = synth_batch(cfg, 100 + i, args.batch, args.seq)
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            if i % 10 == 0 or i == args.steps - 1:
                dt = (time.time() - t0) / (i + 1)
                print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                      f"xent {float(m['xent']):.4f}  {dt * 1e3:.0f} ms/step")
        params = sh.tree_map_with_path(lambda _, p: p.full_tensor(), params)
    head = float(np.mean(losses[:5]))
    tail = float(np.mean(losses[-5:]))
    if not tail < head:
        raise AssertionError(f"training must reduce the loss "
                             f"({head} -> {tail})")
    os.makedirs(os.path.dirname(args.ckpt), exist_ok=True)
    store.save(args.ckpt, params, metadata={"arch": args.arch,
                                            "steps": args.steps,
                                            "final_loss": losses[-1]})
    print(f"checkpoint -> {args.ckpt}(.npz/.json)  "
          f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
