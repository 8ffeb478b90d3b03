"""End-to-end collaborative serving on the PyTorch port, the twin of
``examples/collaborative_serve.py`` (the paper's deployment, §4.3, minus
the Gradio front end): one ``DeploymentPlan`` deployed to both peers, a
cloud server on a localhost socket and an edge client that runs the front
sub-model, ships the split-boundary features over a bandwidth-shaped
(~50 Mbps) channel and receives logits back, both on the CUDA card unless
``--device cpu`` asks for the CPU. The connection opens with the HELLO
handshake, so a peer loading a different plan is rejected.

Pruning masks are compacted on both peers (--no-compact for
masked-but-dense execution), the features cross the wire through --codec,
and --pipeline streams requests through the session's pipelined
infer_many. --trace replays a canned bandwidth trace on both shapers and
--adaptive arms the plan's adaptive section (live RESPLIT).

    PYTHONPATH=src python examples/port_collaborative_serve.py \\
        [--requests 16] [--bandwidth-mbps 50] [--split N] [--codec int8] \\
        [--pipeline] [--trace wifi_degrading] [--adaptive] \\
        [--save-plan DIR | --load-plan DIR] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch import serving
from repro_torch.core.collab.protocol import CODEC_TX_SCALE
from repro_torch.core.partition.profiles import (LinkProfile, PAPER_PROFILE,
                                                 TRACES, TwoTierProfile)
from repro_torch.core.pruning.masks import cnn_masks_from_ratios
from repro_torch.data.synthetic import PlantVillageSynthetic
from repro_torch.models.cnn import init_cnn_params, tiny_cnn_config


def build_plan(args) -> serving.DeploymentPlan:
    cfg = tiny_cnn_config(num_classes=38, hw=32)
    params = init_cnn_params(0, cfg)
    masks = None
    if args.prune < 1.0:
        ratios = {i: args.prune for i, s in enumerate(cfg.layers)
                  if s.kind == "conv" and i > 0}
        masks = cnn_masks_from_ratios(params, cfg, ratios)
    compact = args.compact and masks is not None
    link = LinkProfile(f"{args.bandwidth_mbps} Mbps",
                       bandwidth=args.bandwidth_mbps * 1e6 / 8, rtt_s=2e-3)
    profile = TwoTierProfile(PAPER_PROFILE.device, PAPER_PROFILE.server,
                             link)
    adaptive = None
    if args.adaptive:
        # every interior split plus the endpoints is a legal landing spot
        adaptive = serving.AdaptivePolicy(
            candidates=tuple(range(len(cfg.layers) + 1)))
    # split=None -> greedy optimum on the deployed (compacted/masked)
    # shapes with the codec's wire discount priced in
    return serving.DeploymentPlan.from_args(
        params, cfg, args.split, masks=masks, compact=compact,
        codec=args.codec, pack=not compact and masks is not None,
        profile=profile, port=args.port, adaptive=adaptive)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--bandwidth-mbps", type=float, default=50.0)
    ap.add_argument("--split", type=int, default=None,
                    help="split layer (default: greedy optimum)")
    ap.add_argument("--port", type=int, default=29480)
    ap.add_argument("--prune", type=float, default=0.5,
                    help="preserve ratio for conv layers (1.0 = dense)")
    ap.add_argument("--no-compact", dest="compact", action="store_false",
                    help="run masked-but-dense instead of physically "
                         "compacted submodels")
    ap.add_argument("--codec", choices=list(CODEC_TX_SCALE), default="fp32",
                    help="wire encoding of the split-boundary features")
    ap.add_argument("--pipeline", action="store_true",
                    help="stream requests via the session's pipelined "
                         "infer_many instead of one-at-a-time infer")
    ap.add_argument("--trace", choices=sorted(TRACES), default=None,
                    help="replay a canned time-varying link trace on the "
                         "socket shapers instead of the fixed bandwidth")
    ap.add_argument("--adaptive", action="store_true",
                    help="arm the plan's adaptive section: the session "
                         "re-splits live as the measured link drifts")
    ap.add_argument("--save-plan", default=None, metavar="DIR",
                    help="export the DeploymentPlan artifact and exit")
    ap.add_argument("--load-plan", default=None, metavar="DIR",
                    help="serve a previously exported plan instead of "
                         "building one")
    ap.add_argument("--device", default=None,
                    help="torch device both peers run on (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)

    if args.load_plan:
        plan = serving.DeploymentPlan.load(args.load_plan)
        plan.port = args.port        # transport is not part of the contract
        if (args.split is not None or args.codec != "fp32"
                or not args.compact or args.prune != 0.5
                or args.bandwidth_mbps != 50.0):
            print("note: --load-plan serves the saved contract; "
                  "--split/--codec/--no-compact/--prune/--bandwidth-mbps "
                  "are ignored")
    else:
        plan = build_plan(args)
    print(plan.describe())
    bw_mbps = plan.profile.link.bandwidth * 8 / 1e6
    if args.save_plan:
        plan.save(args.save_plan)
        print(f"plan exported to {args.save_plan}/ "
              f"(serve it with --load-plan)")
        return None

    data = PlantVillageSynthetic(n_per_class=4, hw=32)
    images, labels = [], []
    for i in range(args.requests):
        c, idx = data.test_ids[i % len(data.test_ids)]
        images.append(data._batch(np.array([[c, idx]]))["image"])
        labels.append(c)

    trace = TRACES[args.trace] if args.trace else None
    print(f"serving {args.requests} requests, split c={plan.split}, "
          f"{(trace.name if trace else f'{bw_mbps:g} Mbps')} link, "
          f"masked_layers={len(plan.masks) if plan.masks else 0}, "
          f"compact={plan.compact}, codec={plan.codec}, "
          f"pipeline={args.pipeline}, adaptive={bool(plan.adaptive)}")
    with serving.CloudServer(plan, max_requests=args.requests, trace=trace,
                             device=args.device):
        with serving.connect(plan, backend="socket", trace=trace,
                             device=args.device) as sess:
            t0 = time.time()
            if args.pipeline:
                results = sess.infer_many(images)
            else:
                results = [sess.infer(img) for img in images]
            wall = time.time() - t0
            switches = list(sess.switches)
    for sw in switches:
        print("  " + sw.describe())
    correct, lat = 0, []
    for i, (res, c) in enumerate(zip(results, labels)):
        correct += int(np.argmax(res["logits"]) == c)
        lat.append(res["t_total"] or 0.0)
        print(f"  req {i:2d}: edge {res['t_edge'] * 1e3:6.2f} ms  "
              f"tx {res['tx_bytes']} B")
    lat = np.array(lat)
    print(f"\nthroughput {args.requests / wall:.1f} req/s "
          f"(wall {wall * 1e3:.1f} ms)")
    if not args.pipeline:
        print(f"latency mean {lat.mean() * 1e3:.2f} ms  p50 "
              f"{np.percentile(lat, 50) * 1e3:.2f}  p95 "
              f"{np.percentile(lat, 95) * 1e3:.2f}")
    return results


if __name__ == "__main__":
    main()
