#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py                 # from the repository root; one card
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check kernels

Phases, each printing its own lines:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — every CUDA kernel of the paths, compiled from ``src/repro_torch/
   csrc`` in parallel (one nvcc per source), with ptxas's resource report;
   every ``flash_attention`` and ``rmsnorm`` instance must report 0 bytes
   of spills;
3. kernels — each kernel's wrapper on card tensors at every shape the main
   paths give it, plus edge cases, held against its plain PyTorch version
   with the tolerance stated beside it, and timed with CUDA events beside
   the plain version (rounds taken in turn), one PyTorch call computing
   the same function (``library_ms``) and the card's bound; ``device_ms``
   is the same call replayed from a CUDA graph, without the host's
   enqueue, each call on its own copy of the operands so that they come
   from memory, not from L2, and it must not beat the bound: the fp32
   ``masked_matmul`` at every GEMM of full-width AlexNet (uncompacted and
   with half of every prunable layer's channels compacted away), each row
   naming the route and plan it takes (split-K GEMV, split-K cluster tiles)
   and holding a second call to the same bits; ``masked_matmul_q8`` (int8
   codes dequantized in the kernel's load) at the same full and compacted
   shapes (every shape an int8 plan of phase 4 launches), its
   split-K results bit-identical to the float32 route's on the dequantized
   weights; one ``crossover`` line per M of 1-32 timing the float32 GEMV
   against the split-K tiles at dense14's shape; the bf16 ``masked_matmul`` at
   Qwen2-7B's FFN up/gate shapes (M = 2048 and 2000 in prefill, 1 and 2 in
   decode, and 3, 8, 9, 16, 64; K = 3584; N = 18944; half the columns
   masked), at DeepSeek-V3's dense FFN (M = 2048 and 1, K = 7168, N =
   18432), at HuBERT-XLarge's non-gated FFN (M = 2048 and 2000, K = 1280,
   N = 5120) and at ragged and all-zero-mask shapes, each row naming the
   entry its route picks (the decode GEMV, the wgmma/TMA tiles, the
   CUDA-core tiles), then one ``crossover`` line per M of 1, 2, 3, 4, 8, 16, 64
   timing the GEMV and the tiles on the same operands, and a ``host`` line
   with one call's host time (the bf16, float32 and codes GEMV wrappers,
   ``matmul * mask``); ``rmsnorm`` at
   2048 and 2000 rows of 3584 (R1's and R2's prefill) and 1000, bf16 and
   fp32, offsets 0 and 1, and at 1 and 2 rows (decode), Mixtral-8x7B's
   2048, 8192 and 1 rows of 4096 (R1's and R3's prefill, decode),
   DeepSeek-V3's 2048 and 1 rows of 7168 and 2048 rows of MLA's latent
   widths (``q_norm`` 1536, ``kv_norm`` 512), HuBERT-XLarge's 2048 and 2000
   rows of 1280, with its
   and ``F.rms_norm``'s device time, each row naming its launch plan; its gated
   entry (Mamba2's norm-then-gate) at Mamba2's R1 and R2 (2048 and 2000
   rows of 5120, z a slice of the (rows, 10576) input projection), decode
   (1 and 2 rows), Zamba2's R1 (2048 rows of 4096 in a 8384-wide
   projection), fp32, a ragged width and an unaligned z (the scalar
   route), beside the eager chain and the composite of PyTorch calls that
   computes it; one ``plans`` line per R1 width timing every threads-a-row
   the kernel can take; ``flash_attention`` at (B=1,
   S=2048) and (B=2, S=1000) with 28/4 heads of 128, causal, plus windowed,
   non-causal, fp32, head-dim 64 and ragged (S=77) cases, Zamba2's
   shared attention (32/32 heads of 64, S=2048), gemma-7b's R1 (16/16 heads
   of 256, S=2048) and nemotron-4-340b's heads (96/8 of 192, S=2048), each
   of the two head dims also ragged (S=77) and in fp32, and Mixtral-8x7B's
   R1 and R3 (32/8 heads of 128, causal, window 4096, S=2048 and 8192: at
   8192 whole KV blocks behind the window are skipped), HuBERT-XLarge's R1
   and R2 (16/16 heads of 80, non-causal: the D = 80 instance) with that
   instance also ragged (S=77), in fp32, causal with 16/4 heads and
   windowed, each row with the
   kernel's device time from a CUDA graph, held to the bound; ``ssd_scan`` at
   Mamba2's R1 (B=1, S=2048, 80 heads of 64, d_state 128) and R2 (B=2, S=1000,
   ragged), Zamba2's R1 (64 heads, d_state 64), with half the heads masked,
   x, B and C as slices of one conv output as the block hands them in, plus
   2 groups, S=77, S=1, every head pruned and fp32 cases, the device time
   of each of the bf16 entry's three launches at the two R1 cases;
4. slice (AlexNet) — the paper's int8-quantized, compacted AlexNet
   (``alexnet_config(38)``, 224x224x3, random weights from a seed) served
   through ``repro_torch.serving.connect(plan, backend="local")`` on the
   card at the greedy split, at c=13 (every conv on the edge) and at c=N
   (every layer through the kernel), plus one uncompacted masked plan and
   one c=N plan with float32 weights; the kernel's launch count must equal
   (edge conv+dense layers) x requests, each on the route its shape picks
   (from codes where the plan quantizes), and
   the logits and wire bytes must match the same plan served on the CPU;
5. profile (AlexNet) — where one full-width request's device time goes;
6. slice (Qwen2-7B) — the pruned dense transformer at full width and depth
   (``configs/qwen2_7b.CONFIG``: 28 layers, d_model 3584, 28/4 heads, d_ff
   18944, vocab 152064, bf16; random weights from a seeded CUDA generator;
   masks from ``transformer_masks_from_ratios`` at ratio 0.5 on every unit)
   serving two requests through ``launch.steps.make_prefill_step`` and 16
   greedy ``make_decode_step`` steps each: R1 (B=1, S=2048) and R2 (B=2,
   S=1000). The launch counts must be 57 rmsnorm and 56 masked_matmul per
   forward step and 28 flash_attention per prefill, the prefill's products
   on the wgmma tiles and the decode steps' on the GEMV. The same requests run
   through the plain versions on the card in bf16 and in fp32 (teacher-
   forced with the kernel path's tokens); every logit row of the kernel
   path must lie within twice the bf16 plain run's distance from the fp32
   run, plus one bf16 spacing of the largest logit;
7. profile (Qwen2-7B) — where one R1 prefill's and one decode step's device
   time goes;
8. slice (Mamba2-2.7B) — the pruned SSM at full width and depth
   (``configs/mamba2_2p7b.CONFIG``: 64 layers, d_model 2560, 80 SSD heads of
   64, d_state 128, vocab 50304, bf16; masks at ratio 0.5 keep 40 heads a
   layer) serving R1 and R2 as in phase 6: 64 ssd_scan launches per prefill
   and none per decode step, 65 rmsnorm and 64 gated rmsnorm per forward
   step; the same logit yardstick;
9. slice (Zamba2-1.2B) — the pruned hybrid at full width and depth
   (``configs/zamba2_1p2b.CONFIG``: 38 Mamba2 layers of 64 heads, d_state
   64, one shared attention + GELU-MLP block after every 6th, so 6 groups
   and a tail of 2) serving R1: 38 ssd_scan and 6 flash_attention launches
   per prefill, 51 rmsnorm and 38 gated rmsnorm per forward step; the
   same logit yardstick;
10. profile (Mamba2-2.7B) — where one R1 prefill's and one decode step's
   device time goes;
11. socket (AlexNet) — phase 4's int8 compacted plans served through
   ``serving.CloudServer(plan)`` on 127.0.0.1 and ``serving.connect(plan,
   backend="socket")``, both peers on the card in this process: c=19 (the
   logits cross the wire) and c=13 (the dense layers in the cloud), then
   c=13 with a ``faults`` section and a server that drops one response and
   corrupts another (both recovered by replay), each with ``REQUESTS``
   images sent one after another, every logit row and ``tx_bytes`` equal,
   bit for bit, to the local backend's (at c=19 to its logits through the
   codec), ``masked_matmul`` launches = edge GEMMs x requests on their
   routes; and c=13 with a ``batching`` section (``max_batch`` 4), one
   client alone and then 4 sessions at once, 8 images each, every row equal
   to the sequential logits, the lanes showing batches of more than one
   row. One ``socket`` line per plan: per-request wall ms (median, p90)
   beside the local backend's, and the batched run's req/s beside one
   client's;
12. pipeline (AlexNet) — the paper's pipeline, ``core.pipeline.
   run_paper_pipeline``, at full ``alexnet_config(38)`` width on the card:
   ``PlantVillageSynthetic(n_per_class=8, hw=224)`` (304 images, 228 to
   train), SGD with momentum 0.9 and StepLR, 2 training epochs of 7 steps
   at batch 32, 12 DDPG episodes (4 of warm-up), 1 fine-tuning epoch,
   FLOPs budget 0.5. First one train step on the card (TF32 off) held
   against the same step in float64 on the CPU (the loss and each
   parameter's update within the tolerances stated at ``STEP_LOSS_RTOL``;
   the CPU's float32 step, and the card's with TF32 on, reported beside
   it) and timed, one
   stage-2 reward evaluation timed, the agent alone timed per episode (and
   per episode that updates it, giving the search's seconds per 100
   episodes); then
   the pipeline, whose epoch losses must be finite, FLOPs kept within the
   budget, ratios in [0.05, 1], split tables N + 1 rows with the argmin
   chosen, plan digest unchanged through ``save``/``load``. One
   ``pipeline`` line (the three accuracies printed, not asserted), then
   ``DeploymentPlan.from_pipeline(result, quant=QuantPolicy(8))`` served as
   phase 4 serves its plans (a ``slice`` line);
13. streaming (AlexNet) — phase 4's int8 compacted plans at c=13 and c=19
   through ``serving.connect(plan, backend="streaming",
   realtime_channel=False)``, ``microbatch`` 1 and 4, ``REQUESTS`` images
   each: every logit row and ``tx_bytes`` bit-equal to the local backend's
   (at ``microbatch`` 4 to its halves over the frames the stream fused:
   one int8 scale a frame), ``masked_matmul`` launches = edge GEMMs x
   requests on their routes (the edge stage is the one thread that
   launches). Then, in 2 rounds, the local backend over 256 requests (the
   images taken cyclically) and a stream of the same 256 at each
   ``microbatch``, each held to the same bits. One ``streaming`` line per
   plan and microbatch: the timed streams' req/s beside the local
   backend's over the same requests in the same round (requests over the
   host clock around the whole run), frame sizes, stage occupancy;
14. adaptive and energy (AlexNet) — ``calibrate_quant_edge`` over the c=19
   plan's int8 bank (``CALIBRATION_REPEATS`` timed calls a layer, CUDA
   events around each call with the card idle before it: one request's
   cost of the layer, host enqueue included), its launches = (1 +
   repeats) x 8 edge GEMMs on their routes, and ``measure_cnn_layer_times``
   over its float32 layers (a ``calibrate`` line beside phase 4's edge
   wall ms); the Eq. 5 sweep on PAPER_PROFILE over the measured times
   (N + 1 rows, the argmin) beside the analytic pick; the energy-aware
   picks and Pareto fronts of a phone-class edge (``PHONE_EDGE``,
   ``PHONE_ENERGY``) at 50 and 10 Mbps over the calibrated and the
   analytic costs (``energy`` lines; weight 0 picks the greedy split, T
   ascending and E strictly descending along the front). Then phase 4's
   c=13 plan re-cut for a phone-class edge with ``adaptive`` (candidates
   0, 3, 6, 13, 19) and ``energy`` (2 J battery) sections, starting at
   c=3: ``connect(plan, "local", trace=...)`` over ``ADAPTIVE_REQUESTS``
   requests on a link that falls from 50 to 2 Mbps (``ADAPTIVE_TRACE``),
   the switch list equal to the same session's on ``device="cpu"`` and
   non-empty, each request bit-equal to a fixed-split session at the
   split it ran at, its ``e_edge_j`` the profile's price of its timing,
   ``masked_matmul`` launches the sum of its splits' edge GEMMs (the
   candidates' warm-up counted apart), and the host cost of the control
   loop (per-request wall ms beside the fixed-split sessions', a sweep's
   host us); the same plan over the socket (no link shaper: the loopback
   is fast, so the edge's controller offloads by a RESPLIT on the live
   connection, then a manual ``resplit`` to c=19 that the controller
   adopts), every row and ``tx_bytes`` bit-equal to the local backend's at
   its split; the energy plan at c=13 streamed at ``microbatch`` 1 and 4,
   every ``e_edge_j`` > 0 and equal to its formula (the RTT split over a
   frame's requests);
15. the device model, the roofline and the fleet — the card's name, SM
   count and memory beside ``repro_torch.roofline.hw``'s, a 1 GiB
   device-to-device copy (bytes read plus written over CUDA-event time)
   as a share of ``hw.HBM_BW`` and a cuBLAS bf16 GEMM at 8192^3 as a share
   of ``hw.PEAK_FLOPS_BF16``, each share at most 1 (a ``device_model``
   line); ``quant_edge_roofline`` of the c=19 int8 plan on ``H100_CARD``,
   each conv and fc row beside phase 14's calibrated time of that layer
   and their ratio (at least 1: no time beats its bound), and
   ``check_quant_edge_roofline`` on ``MCU_EDGE`` and ``PI_EDGE`` (a
   ``roofline`` line); ``simulate_fleet`` over ``benchmarks/fleet_sim.py``'s
   cells (``FLEET_CELLS``: the two fast cells, then the five-cell grid up
   to 10,000 edges x 60 s), every cell conserving arrivals (served + shed),
   the headline held to ``experiments/bench/BENCH_fleet.json`` (integers
   exactly, floats within ``FLEET_RECORD_RTOL``; the record predates the
   rollup's ``chaos_reroutes_count``) and to a same-seed rerun with ``==``,
   the strict cell to the record's ``strict_*`` keys, with p50/p99
   latency, J a request, deadlines met, the share shed and the host's wall
   seconds (``fleet`` lines); and phase 4's c=13 plan with a ``fleet``
   section, saved and loaded (the digest through the files, unlike the
   bare plan's), served through ``connect`` on ``local``, ``socket`` and
   ``streaming`` (``microbatch`` 1), ``REQUESTS`` images each, every logit
   row and ``tx_bytes`` bit-equal to the bare plan's on the same backend,
   ``masked_matmul`` launches = edge GEMMs x requests on their routes (a
   ``fleet_plan`` line);
16. slice (Mixtral-8x7B) — the pruned MoE stack at full width
   (``configs/mixtral_8x7b.CONFIG``: d_model 4096, 32/8 heads of 128, 8
   experts of d_expert 14336, top-2, capacity factor 1.25, window 4096,
   vocab 32000, bf16) with its depth cut to 16 of 32 layers (32 do not fit
   the card; the ``slice`` line says ``layers 16 of 32``); masks at ratio
   0.5 keep 4 of 8 experts and 4 of 8 KV groups a layer. R1 (B=1, S=2048)
   and R3 (B=1, S=8192, past the window: the decode cache is the rolling
   4096-slot buffer), each a prefill and 16 greedy decode steps through
   the serving steps: 33 rmsnorm launches a forward step, 16
   flash_attention a prefill, no masked_matmul. The same requests through
   the bf16 plain versions, teacher-forced; a ``moe_routing`` line a
   request with each prefill layer's drop_frac and the share of (token, k)
   routes on which the two runs pick the same expert (reported: routing
   is discontinuous). ``profile`` lines of one R1 and one R3 prefill,
   each followed by a decode step. Then phase 6's logit yardstick on the
   first 4 layers of the same weights (views of the served tensors, made
   float32 tensor by tensor, never a bf16 and a float32 tree whole at
   once), steps whose own tokens the kernel path and the bf16 plain run
   routed apart reported and not held; a ``phase16`` line with the
   phase's seconds and the most memory it allocated on the card;
17. slice (DeepSeek-V3) — the pruned MLA + MoE stack at full width
   (``configs/deepseek_v3_671b.CONFIG``: d_model 7168, 128 heads, MLA
   ranks 1536/512, nope/rope/v head dims 128/64/128, 3 dense layers of
   d_ff 18432 first, then 256 experts of 2048 + 1 shared, top-8, sigmoid
   scores, capacity factor 1.0, vocab 129280, bf16, an MTP block built
   and never run) with its depth cut to 5 of 61 layers (3 dense + 2 MoE:
   55.2 GB; ``layers 5 of 61``); masks at ratio 0.5 keep 64 of 128 heads,
   9216 of 18432 FFN channels and 128 of 256 experts a layer. R1 (B=1,
   S=2048: MLA's naive attention) and R3 (B=1, S=8192: past
   ``naive_attn_max``, its chunked attention), each a prefill and 16
   greedy decode steps through the serving steps: 21 rmsnorm launches a
   forward step (4 a layer: the two pre-norms, ``q_norm`` and
   ``kv_norm``, and the final norm), 6 masked_matmul a step (the dense
   layers' up and gate products: wgmma tiles at prefill, the GEMV in
   decode), no flash_attention (MLA's attention is plain PyTorch, as the
   reference's). Then, as phase 16, the bf16 plain run, a ``moe_routing``
   line a request and ``profile`` lines; then the yardstick at R1 on
   the first 4 layers (3 dense + 1 MoE; the MTP block released), as in
   phase 16, and a ``phase17`` line.
18. slice (Qwen2-VL-7B) — the pruned vision-language decoder at full
   width and depth (``configs/qwen2_vl_7b.CONFIG``: Qwen2-7B's backbone,
   M-RoPE sections 16/24/24, 1024 vision tokens, bf16; 28 of 28 layers;
   masks at ratio 0.5). R1 (B=1: 1024 vision embeddings, seeded normal
   draws, then 1024 text tokens) and R2 (B=2: 1024 + 976), the vision
   prefix's M-RoPE ids on a 32 x 32 grid and the text's after it, each a
   prefill and 16 greedy decode steps through the serving steps (decode
   at the sequence length, the reference's position): 57 rmsnorm a step,
   28 flash_attention a prefill, 56 masked_matmul a step. Phase 6's logit
   yardstick; then a ``consistency`` line: at R1 on text ids, prefill +
   4 decode steps against one ``forward``, all the fp32 plain version,
   within 2e-3 of the largest logit. ``profile`` lines of one R1 and one
   R2 prefill, each with a decode step, and a ``phase18`` line (seconds,
   peak memory);
19. slice (HuBERT-XLarge) — the pruned audio encoder at full width and
   depth (``configs/hubert_xlarge.CONFIG``: 48 layers, d_model 1280,
   16/16 heads of 80, a GELU FFN of 5120, non-causal, vocab 504, bf16;
   masks at ratio 0.5). R1 (B=1, 2048 frame embeddings) and R2 (B=2, 1000
   frames), prefill only (an encoder has no decode step): 97 rmsnorm, 48
   flash_attention (D = 80) and 48 masked_matmul (one up product a
   layer: the FFN has no gate). Every position's logits (B, S, 504) held
   to the fp32 plain run as phase 6 holds its rows; ``profile`` lines of
   one R1 and one R2 prefill and a ``phase19`` line;
20. training — ``launch.steps.make_train_step`` (``loss_fn`` by autograd,
   the forward on the ``rmsnorm``, ``masked_matmul`` and
   ``flash_attention`` kernels, each an autograd Function whose backward
   is in PyTorch ops; remat on, as in the configs) with AdamW at the
   reference's defaults and a constant learning rate, on one fixed batch
   from ``data.tokens.MarkovTokens``, for three pruned models at full
   width (``TRAIN_RUNS``; masks at ratio 0.5 through ``model_setup``): T1
   Qwen2-VL-7B cut to 4 of 28 layers (1,024 seeded vision embeddings on
   the 32 x 32 grid, then 1,024 tokens), T2 HuBERT-XLarge cut to 24 of 48
   (2,048 frames, labels in [0, 504)), T3 DeepSeek-V3 cut to its first
   (dense MLA) layer plus the MTP block (1,024 tokens, bf16 moments). A
   ``slice`` line each (``layers 4 of 28``, ``24 of 48``, ``1 of 61 +
   mtp``, with the cut's reason); the loss and every gradient three ways
   (the kernel path, the bf16 plain run, the fp32 plain run on a float32
   copy with TF32 off), each metric and each leaf's relative L2 gap to
   the fp32 run within twice the bf16 plain run's plus one bf16 spacing,
   no leaf skipped; every pruned unit's gradient exactly zero on the
   kernel path; 8 steps (T3: 2) with the launch counters zeroed just
   before and read just after, equal to ``expected_train_launches``
   (every layer's kernels twice a step under remat), the loss falling;
   for T1 one step at B = 2 with ``grad_accum`` 2 against 1 (the loss
   within one bf16 spacing, both peaks reported); ``device_profile`` of
   one step by kind, the device ms of its forward, forward and backward,
   and AdamW update on their own, and of one ``flash_attention_backward``
   at the run's shape. A ``train`` line each and a ``phase20`` line.
21. mesh and examples — phase 20's T1 (Qwen2-VL-7B, 4 of 28 layers, masks
   at ratio 0.5, one fixed batch of 1,024 vision + 1,024 text positions),
   T3 (DeepSeek-V3's dense MLA layer and its MTP block, 1,024 tokens,
   bf16 moments) and T5 (Zamba2-1.2B cut to 12 of 38 layers, two
   invocations of its shared block, 2,048 tokens: its SSD heads and
   shared block split) through the sharded train step
   (``make_train_step(mesh=...)``) on the split route of
   ``sharding.tensor_parallel``, each on the
   ``(1, 1)`` host mesh of a one-rank NCCL group (``launch.mesh.
   host_mesh``; the parameters and AdamW state as DTensors placed by
   ``sharding.specs``): 2 steps with the launch counters zeroed just
   before and read just after (``expected_train_launches``), held bit for
   bit against 2 steps of the unsharded step from the same weights (the
   loss and every parameter; were they not bit-equal, a second unsharded
   run would show the card's own run-to-run spread, and the sharded run
   would be held within twice it plus one bf16 spacing), its wall and
   device ms (``device_profile`` of one more step, beside the unsharded
   step's) and peak memory, and each run's peak above the memory held
   before it, from its optimizer's init through its profiled step, the
   route it took checked (a ``train`` line each, ``"run": "T1 mesh"``,
   ``"T3 mesh"`` and ``"T5 mesh"``; the group destroyed at the end of
   each); then the four
   example twins on the card (``examples/port_*.py``: the quickstart at
   its defaults, the collaborative serve with 8 int8 requests pipelined
   over the socket, the prune-and-split of Qwen2-7B, the training twin of
   Qwen2-7B under its own host mesh), each printing its own lines between
   ``twin <name> start`` and a ``twin`` line with its seconds and
   launches; and the transformer split of every registry config under the
   ``h100_two_node`` and ``h100_edge_cloud`` profiles at 4,096-token
   prefill and decode, greedy and balanced (``split`` lines). A
   ``phase21`` line.
22. split serve — two dry-run cells in subprocesses on the CPU, then the
   pipelined split (``core.partition.pod_pipeline``, one pod on a
   one-rank NCCL mesh, its stage on the split route, 32 x 4,096 tokens in
   8 microbatches) of Qwen2-7B and Mamba2-2.7B at full width and depth
   against the prefill step on the same batch: bit-equal (held), gaps to
   the fp32 plain run, wall and device ms, peaks beside PR 27's, launches,
   the route of the step and of its dry run (``split_serve`` lines, a
   ``dryrun`` line and a ``phase22`` line).
23. tensor parallelism — the pruned Qwen2-7B at full width, 14 of its 28
   layers (``TP_QWEN_LAYERS``, for the script's time), on the split route
   (``sharding.tensor_parallel``): (a) an R1 prefill and
   16 greedy decode steps through the mesh steps on the one-rank NCCL
   host mesh, bit for bit against the unsharded steps, with the same
   launches, wall and device ms and peaks beside the unsharded run's;
   (b) the "model" = 2 split's two shares run one after another on the
   card (``SequentialRanks``: 14 heads over 2 KV heads, FFN columns N =
   9,472 and half the vocabulary a rank), a prefill and 4 decode steps,
   both ranks' logits bit-equal, launches exactly twice one request's,
   every logit row within phase 6's rule of the unsharded bf16 and fp32
   plain runs teacher-forced with its tokens. Then the MoE stacks, pruned
   at full width, the MTP block released: Mixtral-8x7B at 4 of 32 layers
   and DeepSeek-V3 at its 3 dense layers and 1 MoE layer, (c) an R1
   prefill and 4 decode steps through the mesh steps on the one-rank
   mesh, bit-equal to the unsharded steps with the same launches, (d)
   the "model" = 2 split rank after rank held as (b), every step, the
   plain runs taking the split's own routes (the share of routes the
   split and the unsharded kernel path pick alike reported, and the
   steps they routed apart);
   (e) Mixtral-8x7B at 2 layers on "model" = 16 rank after rank (two
   ranks an expert, 7,168 columns each; its 8 KV heads on the head dim,
   the decode's queries sent to the cache), an R1 prefill and 2 decode
   steps held as (d). Then the pruned Mamba2-2.7B at full width: (f) 8 of
   its 64 layers, an R1 prefill and 4 decode steps through the mesh steps
   on the one-rank mesh, bit-equal to the unsharded steps with the same
   launches; (g) its "model" = 2 split rank after rank (40 SSD heads and
   2,560 gated-norm columns a rank; the gated norm through the two split
   entries, its row sums of squares added over the ranks) held as (b);
   (h) 2 layers on "model" = 16 rank after rank (5 heads, 320 columns a
   rank: the pod's split) held as (b) (``tensor_parallel`` lines and a
   ``phase23`` line).
   Phase 3 holds the kernels at these shard
   shapes too: the bf16 ``masked_matmul`` at N = 9,472 and 1,184
   (Qwen2-7B's d_ff over 2 and 16 ranks), M = 2,048 and 1;
   ``flash_attention`` at 14 heads over 2 and 2 over 1 (D = 128) and
   gemma-7b's 1 over 1 (D = 256); the rmsnorm kernel's two split gated
   entries (a rank's row sums of squares, and the normalization given the
   whole row's) at Mamba2-2.7B's 2,048 x 320 (16 ranks) and 2,048 x 2,560
   (2 ranks) and decode, fp32 and ragged cases; ``ssd_scan`` at a rank's
   5 heads (B = 1, S = 2,048, P = 64, N = 128).
24. context parallelism — the sequence split over "data" = 2
   (``sharding.context_parallel``), its two shares run one after another
   on the card (``SequentialRanks``) at full width and B = 1: the pruned
   Qwen2-7B at 4 of its 28 layers, Mamba2-2.7B at 4 of 64 (the SSD state
   passed from the first share's block to the second's, each block
   through the bf16 ``ssd_scan`` kernel) and DeepSeek-V3 at 1 dense and 1
   MoE layer (MLA's latents gathered, the dispatch over the whole
   request), an R1 prefill (1,024 positions a share, the second share's
   queries through the flash kernel at ``q_offset`` 1,024) and 4 decode
   steps (each share scoring its half of the cache's slots, the partial
   softmaxes combined): both shares' logits bit-equal, launches twice one
   request's, every logit row within phase 6's rule of the unsharded bf16
   and fp32 plain runs teacher-forced with its tokens (the plain runs
   taking the split's routes), wall and device ms (``context_parallel``
   lines and a ``phase24`` line). Phase 3 holds the flash kernel at the
   second share's shapes: 1,024 queries at ``q_offset`` 1,024 against
   2,048 keys, Qwen2-7B's 28/4 heads causal, Mixtral-8x7B's 32/8 with its
   window, a window of 512 that cuts the keys, and the fp32 entry.
25. the train step on a sequence split — "data" = 2 at B = 1 and 2,048
   tokens (1,024 positions a share; the second share's flash forward,
   and its backward in PyTorch ops, at ``q_offset`` 1,024), full width,
   masks at ratio 0.5: the pruned Qwen2-7B at 4 of its 28 layers,
   Mamba2-2.7B at 4 of 64 (each block's ``ssd_scan``, the state carried
   and the conv's halo, and their backwards), DeepSeek-V3's first (dense
   MLA) layer and its MTP block (MLA's latents gathered, the MTP shift
   across the blocks' boundary) and Mixtral-8x7B at 2 of 32 (the
   dispatch over the whole request and its backward). The two shares run
   in two processes on the card (``cp_train_worker``) joined by a gloo
   group (gloo takes the card's tensors and stages them through host
   memory itself), each the share's loss and gradient
   (``launch.steps.share_loss_and_grads``) with no optimizer update: a
   ``device_profile`` of it, then once more with the launch counters
   zeroed just before and read just after (each share one unsharded
   train step's launches, ``expected_train_launches``); the shares'
   weighted metrics all-reduced (both shares' the same bits); share 1's
   gradient handed to share 0 in the card's memory, and the loss and
   every gradient leaf summed over the shares within phase 20's rule of
   the unsharded step (twice the bf16 plain run's gap to the fp32 plain
   run, plus one bf16 spacing), the unsharded kernel path's gap beside
   it; wall and device ms, idle share and peak GB a share
   (``context_parallel_train`` lines and a ``phase25`` line).

It then prints the kernels' JSON line (the ``masked_matmul`` launches of
phases 4, 11-15 and 21, counted where one thread launches; the
transformer kernels' of phases 6, 8, 9 and 16-25, the rmsnorm kernel's two
split gated entries those of phase 23 (g) and (h) at a 16-rank share's
2,048 x 320; ``flash_attention_d80``, the D = 80
instance over one HuBERT R1 prefill with phase 19's and T2's launches),
the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero without that line; so does a machine without a CUDA device.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.roofline import hw  # noqa: E402

SEED = 0
REQUESTS = 8
#: phase 13's timed streams: requests a stream (the images taken
#: cyclically; a few hundred, so a stream's start and drain are a small
#: part of its window) and rounds of local backend, then streams
STREAM_REQUESTS = 256
STREAM_ROUNDS = 2
#: H100 SXM peaks from the port's device model (``repro_torch.roofline.hw``:
#: NVIDIA's data sheet at the 700 W power limit): HBM3 bandwidth, the fp32
#: rate of the CUDA cores and the dense bf16 rate of the tensor cores; a
#: bound takes the peak of its inputs' type
PEAK_BYTES_S = hw.HBM_BW
PEAK_FP32_FLOP_S = hw.PEAK_FLOPS_FP32
PEAK_BF16_FLOP_S = hw.PEAK_FLOPS_BF16
#: the card's L2 cache (50 MB on an H100 SXM), and the most operand copies
#: ``graph_ms`` rotates through to read past it
L2_BYTES = hw.L2_BYTES
GRAPH_COPIES = 256
#: the TPU kernel each CUDA kernel replaces; the rmsnorm kernel's gated
#: entry replaces an XLA fusion of the reference (no Pallas kernel)
REPLACES = {"masked_matmul": "src/repro/kernels/masked_matmul/kernel.py:26",
            "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:20",
            "rmsnorm_gated": "src/repro/models/layers/norms.py:45",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:38",
            "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:36"}
SOURCES = {name: f"src/repro_torch/csrc/{name.split('_gated')[0]}.cu"
           for name in REPLACES}
#: bf16 keeps 8 significant bits: two roundings of nearby fp32 values to
#: bf16 differ by at most their gap plus 2**-7 of the value
BF16_SPACING = 2.0 ** -7
#: the transformer requests: (label, batch, prompt length); 16 decode steps
TRANSFORMER_REQUESTS = (("R1", 1, 2048), ("R2", 2, 1000))
#: float32 eps
EPS32 = 2.0 ** -23
DECODE_STEPS = 16


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean ms of ``reps`` back-to-back calls,
    from CUDA events after a warm-up. A call slower than 2.5 ms takes fewer
    reps (at least 3), so that a round lasts about 50 ms."""
    return time_interleaved_ms({"": fn}, reps, rounds)[""]


def time_interleaved_ms(fns, reps: int = 20, rounds: int = 5):
    """``time_ms`` of each function of the dict ``fns``, their rounds taken
    in turn (one round of each, then the next), so that a stretch of host
    noise falls on all of them alike; a dict of the medians."""
    import torch

    def one_round(fn, n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n
    n = {k: max(3, min(reps, int(50.0 / max(one_round(fn, 1), 1e-3))))
         for k, fn in fns.items()}
    samples = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            samples[k].append(one_round(fn, n[k]))
    return {k: statistics.median(v) for k, v in samples.items()}


def copy_like(t):
    """``t`` in new memory: its whole storage copied, then viewed with its
    own sizes, strides and offset (a slice of a larger tensor stays one)."""
    import torch
    storage = t.untyped_storage()
    flat = torch.empty(0, dtype=t.dtype, device=t.device).set_(
        storage, 0, (storage.nbytes() // t.element_size(),)).clone()
    return flat.as_strided(t.shape, t.stride(), t.storage_offset())


def graph_ms(fn, *operands, reps: int = 20) -> float:
    """Device time of one ``fn(*operands)`` with its operands read from the
    card's memory: calls captured in a CUDA graph after a warm-up call, each
    on its own copy of the operands, as many copies as together exceed
    three times the L2 (at most ``GRAPH_COPIES``: operands under 0.6 MB may
    stay in L2, where reading them from memory would cost under 0.2 µs),
    so that no call finds its inputs left in L2 by the calls before it; the
    graph replayed as ``time_ms`` times it. Back-to-back calls of a small
    kernel wait on the host's enqueue (a wrapper call costs tens of µs);
    the replay does not."""
    import torch
    nbytes = sum(t.numel() * t.element_size() for t in operands)
    copies = max(2, min(GRAPH_COPIES, -(-3 * L2_BYTES // max(nbytes, 1))))
    sets = [operands] + [tuple(copy_like(t) for t in operands)
                         for _ in range(copies - 1)]
    calls = max(reps, copies)
    fn(*operands)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(calls):
            fn(*sets[i % copies])
    torch.cuda.synchronize()
    ms = time_ms(graph.replay, reps=5) / calls
    del graph, sets
    return ms


def hold_to_bound(row):
    """No time measured on the card can beat the card's bound: a device
    time under ``bound_ms`` means the replay did not read its operands from
    memory. Adds ``device_over_bound`` (and the library's) to ``row``;
    returns whether both are at least 1."""
    row["device_over_bound"] = row["device_ms"] / row["bound_ms"]
    ok = row["device_over_bound"] >= 1.0
    if row.get("library_device_ms") is not None:
        row["library_device_over_bound"] = (row["library_device_ms"]
                                            / row["bound_ms"])
        ok = ok and row["library_device_over_bound"] >= 1.0
    return ok


def gemm_shapes(cfg):
    """(layer, M, K, N) of every conv (im2col) and dense GEMM of one
    batch-1 request through ``cfg``."""
    from repro_torch.models.cnn import layer_shapes
    shapes = layer_shapes(cfg)
    c_in = cfg.input_channels
    out = []
    for i, spec in enumerate(cfg.layers):
        if spec.kind == "conv":
            c, h, w = shapes[i]
            out.append((f"conv{i}", h * w, c_in * spec.kernel ** 2, c))
            c_in = c
        elif spec.kind == "dense":
            out.append((f"dense{i}", 1, shapes[i - 1][0], spec.features))
    return out


def set_bound(row, nbytes: float, flops: float, peak_flop_s: float):
    """Add ``bytes_ms``, ``ops_ms``, ``bound_ms`` (the larger) and
    ``bound_by`` to ``row``: the bytes the function must move at the memory
    rate against its operations at the peak of its inputs' type."""
    row["bytes_ms"] = 1e3 * nbytes / PEAK_BYTES_S
    row["ops_ms"] = 1e3 * flops / peak_flop_s
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] > row["ops_ms"]
                       else "operations")
    return row


def masked_matmul_bound(row, M: int, K: int, N: int, kept: int,
                        itemsize: int, codes: bool = False):
    """The masked GEMM needs only the kept columns: A and the kept columns
    of B read once, the mask read and C written once, against 2*M*K*kept
    + M*N operations (fp32 peak for fp32 operands, bf16 for bf16). With
    ``codes`` B is read at 1 byte an element, plus its float32 scale and
    zero, and each kept code costs a dequant (2 operations) once."""
    b_bytes = K * kept if codes else itemsize * K * kept
    nbytes = itemsize * (M * K + M * N) + b_bytes + 4 * N + (8 * N if codes
                                                             else 0)
    flops = 2 * M * K * kept + M * N + (2 * K * kept if codes else 0)
    return set_bound(row, nbytes, flops, PEAK_FP32_FLOP_S if itemsize == 4
                     else PEAK_BF16_FLOP_S)


def check_no_spills(name: str, log: str) -> None:
    """Phase 2: every kernel instance ptxas compiled for ``name`` (each
    ``Compiling entry`` of its log) reports 0 bytes of spill stores and
    loads; prints one ``build`` line with the count."""
    entries = log.count("Compiling entry")
    spills = [tuple(map(int, m)) for m in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    bad = [sp for sp in spills if sp != (0, 0)]
    print(f"build {name}: {entries} instances, {len(spills)} spill reports, "
          f"{len(bad)} with spills", flush=True)
    if not entries or len(spills) < entries or bad:
        raise AssertionError(f"{name}: ptxas reports spills or no report "
                             f"({entries} instances, spills {spills})")


def check_row(kernel: str, row, ok: bool):
    print(f"kernel {kernel} " + json.dumps(row), flush=True)
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version "
                             f"at {row['case']}: {row}")
    return row


def matmul_times_mask(a, b, m):
    """The library call computing the masked GEMM."""
    import torch
    return torch.matmul(a, b) * m


def check_masked_matmul(cases, dtype: str = "float32"):
    """Phase 3: kernel against plain version at each (name, M, K, N, mask
    kind) with operands of ``dtype``; returns the per-case rows."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.masked_matmul.ops import _plan, masked_matmul
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    eps = torch.finfo(torch.float32).eps
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    with exact_fp32():
        for name, M, K, N, kind in cases:
            a = torch.randn(M, K, device="cuda", generator=gen).to(dt)
            b = (torch.randn(K, N, device="cuda", generator=gen)
                 / K ** 0.5).to(dt)
            if kind == "ones":
                m = torch.ones(N, device="cuda")
            elif kind == "zeros":
                m = torch.zeros(N, device="cuda")
            elif kind == "half":
                m = torch.zeros(N, device="cuda")
                m[torch.randperm(N, device="cuda", generator=gen)[:N // 2]] = 1
            else:
                m = (torch.rand(N, device="cuda", generator=gen)
                     < 0.5).float()
            got = masked_matmul(a, b, m)
            torch.cuda.synchronize()
            want = masked_matmul_ref(a, b, m)
            torch.cuda.synchronize()
            # tolerance: two fp32 sums of the same K products in different
            # orders differ by at most K·eps·(|A|@|B|) per element (each
            # errs by at most K·u·sum|a_k b_k|, u = eps/2); a bf16 output
            # adds one bf16 spacing of the value
            tol = K * eps * (a.float().abs() @ b.float().abs())
            if dtype == "bfloat16":
                tol = tol + BF16_SPACING * (want.float().abs() + tol)
            err = (got.float() - want.float()).abs()
            pruned_exact = bool((got[:, m == 0] == 0).all())
            ok = bool((err <= tol).all()) and pruned_exact
            entry, plan = _plan(dt, M, K, N)
            # the cluster routes sum their partial tiles in a fixed order:
            # a second call gives the same bits
            same = (bool(torch.equal(got, masked_matmul(a, b, m)))
                    if plan else None)
            ok = ok and same is not False
            row = {"case": name, "dtype": dtype, "M": M, "K": K, "N": N,
                   "mask": kind, "kept": int(m.sum()), "entry": entry,
                   "plan": list(plan), "max_abs_err": float(err.max()),
                   "max_err_over_tol": float((err / tol.clamp_min(1e-30))
                                             .max()),
                   "pruned_exact_zero": pruned_exact,
                   "bit_identical_rerun": same,
                   **time_interleaved_ms(
                       {"ms": lambda: masked_matmul(a, b, m),
                        "plain_ms": lambda: masked_matmul_ref(a, b, m),
                        "library_ms": lambda: torch.matmul(a, b) * m},
                       rounds=9),
                   "device_ms": graph_ms(masked_matmul, a, b, m),
                   "library_device_ms": graph_ms(matmul_times_mask, a, b, m)}
            masked_matmul_bound(row, M, K, N, row["kept"], a.element_size())
            row["ok"] = ok = ok and hold_to_bound(row)
            rows.append(check_row("masked_matmul", row, ok))
            del a, b, got, want, tol, err
    return rows


def q8_operands(M: int, K: int, N: int, gen):
    """A float32 (M, K) and uint8 codes (K, N) with per-column scale and
    zero as ``quantize_weights`` makes them (zero the column's minimum,
    scale its range over 255 levels), for weights of spread K**-0.5."""
    import torch
    a = torch.randn(M, K, device="cuda", generator=gen)
    codes = torch.randint(0, 256, (K, N), device="cuda", generator=gen,
                          dtype=torch.uint8)
    spread = (1 + torch.rand(N, device="cuda", generator=gen)) / K ** 0.5
    scale = 2 * spread / 255
    zero = -spread * (1 + 0.1 * torch.rand(N, device="cuda", generator=gen))
    return a, codes, scale, zero


def check_masked_matmul_q8(cases):
    """Phase 3: ``masked_matmul_q8`` (codes dequantized in the kernel's
    load) against the plain version after the dequant, ``codes * scale +
    zero`` as ``quant.dequantize_weights`` rounds it, at each (name, M, K,
    N, mask kind); the library call is ``torch.matmul`` on the dequantized
    B times the mask. The split-K route must also give, bit for bit, what
    the float32 split-K route gives on the dequantized B (the same tiles and
    split, so the same sums in the same order: the dequant is exact)."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.masked_matmul import ops
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = []
    with exact_fp32():
        for name, M, K, N, kind in cases:
            a, codes, scale, zero = q8_operands(M, K, N, gen)
            m = (torch.ones(N, device="cuda") if kind == "ones" else
                 (torch.rand(N, device="cuda", generator=gen) < 0.5).float())

            def plain():
                return masked_matmul_ref(a, codes.float() * scale + zero, m)

            def library(a, codes, scale, zero, m):
                return torch.matmul(a, codes.float() * scale + zero) * m
            got = ops.masked_matmul_q8(a, codes, scale, zero, m)
            torch.cuda.synchronize()
            b = codes.float() * scale + zero
            want = masked_matmul_ref(a, b, m)
            tol = K * eps * (a.abs() @ b.abs())
            err = (got - want).abs()
            pruned_exact = bool((got[:, m == 0] == 0).all())
            entry, plan = ops._plan(torch.uint8, M, K, N)
            same = bool(torch.equal(
                got, ops.masked_matmul_q8(a, codes, scale, zero, m)))
            as_f32 = None
            if entry == ops._ENTRIES["q8_splitk"]:
                as_f32 = bool(torch.equal(got, ops._launch(
                    a, b, m, ops._ENTRIES["f32_splitk"], plan)))
            ok = (bool((err <= tol).all()) and pruned_exact and same
                  and as_f32 is not False)
            operands = (a, codes, scale, zero, m)
            row = {"case": name, "dtype": "uint8 codes", "M": M, "K": K,
                   "N": N, "mask": kind, "kept": int(m.sum()),
                   "entry": entry, "plan": list(plan),
                   "max_abs_err": float(err.max()),
                   "max_err_over_tol": float((err / tol.clamp_min(1e-30))
                                             .max()),
                   "pruned_exact_zero": pruned_exact,
                   "bit_identical_rerun": same,
                   "bit_identical_to_f32_splitk": as_f32,
                   **time_interleaved_ms(
                       {"ms": lambda: ops.masked_matmul_q8(*operands),
                        "plain_ms": plain,
                        "library_ms": lambda: library(*operands)},
                       rounds=9),
                   "device_ms": graph_ms(ops.masked_matmul_q8, *operands),
                   "library_device_ms": graph_ms(library, *operands)}
            masked_matmul_bound(row, M, K, N, row["kept"], 4, codes=True)
            row["ok"] = ok = ok and hold_to_bound(row)
            rows.append(check_row("masked_matmul", row, ok))
            del a, codes, b, got, want, tol, err
    return rows


def f32_gemv_splitk_crossover(rows_m, K: int, N: int):
    """Phase 3: the float32 product at each M of ``rows_m`` through the
    split-K GEMV and the split-K tiles, each with the plan the host would
    give it, whatever ``_route`` picks: each held to ``check_masked_matmul``'s
    tolerance and timed from a CUDA graph (device time) and back to back;
    one ``crossover`` line per M. These launches are for comparison only."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.masked_matmul import ops
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    with exact_fp32():
        for M in rows_m:
            a = torch.randn(M, K, device="cuda", generator=gen)
            b = torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5
            m = torch.ones(N, device="cuda")
            want = masked_matmul_ref(a, b, m)
            tol = K * eps * (a.abs() @ b.abs())
            routes = {"gemv": (ops._ENTRIES["f32_gemv"],
                               ops._gemv_f32_plan(False, M, K, N, True)),
                      "splitk": (ops._ENTRIES["f32_splitk"],
                                 ops._splitk_plan(M, K, N)
                                 + (4 if N % 4 == 0 else 1,))}
            row = {"dtype": "float32", "M": M, "K": K, "N": N,
                   "entry": ops._route(torch.float32, M, K, N)}
            for label, (symbol, plan) in routes.items():
                got = ops._launch(a, b, m, symbol, plan)
                torch.cuda.synchronize()
                over = float(((got - want).abs() / tol.clamp_min(1e-30))
                             .max())
                if over > 1.0:
                    raise AssertionError(f"masked_matmul {label} route at "
                                         f"M={M} disagrees with its plain "
                                         f"version ({over} of the tolerance)")
                row[f"{label}_plan"] = list(plan)
                row[f"{label}_device_ms"] = graph_ms(
                    lambda a, b, m: ops._launch(a, b, m, symbol, plan),
                    a, b, m)
                row[f"{label}_ms"] = time_ms(
                    lambda: ops._launch(a, b, m, symbol, plan))
                row[f"{label}_err_over_tol"] = over
            row["library_device_ms"] = graph_ms(matmul_times_mask, a, b, m)
            print("crossover " + json.dumps(row), flush=True)
            rows.append(row)
    return rows


def gemv_tiles_crossover(rows_m, K: int, N: int):
    """Phase 3: the bf16 product at each M of ``rows_m`` through both
    Hopper routes, the GEMV and the wgmma tiles, whatever ``_route`` would
    pick: each held against the plain version with the tolerance of
    ``check_masked_matmul`` and timed; one ``crossover`` line per M. These
    launches are for comparison only."""
    import torch
    from repro_torch.kernels.masked_matmul import ops
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    routes = {"gemv": ops._ENTRIES["gemv"], "tiles": ops._ENTRIES["tiles"]}
    rows = []
    for M in rows_m:
        a = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
        b = (torch.randn(K, N, device="cuda", generator=gen)
             / K ** 0.5).to(torch.bfloat16)
        m = torch.zeros(N, device="cuda")
        m[torch.randperm(N, device="cuda", generator=gen)[:N // 2]] = 1
        want = masked_matmul_ref(a, b, m).float()
        tol = K * eps * (a.float().abs() @ b.float().abs())
        tol = tol + BF16_SPACING * (want.abs() + tol)
        row = {"M": M, "K": K, "N": N, "entry": ops._route(
            torch.bfloat16, M, K, N)}
        for label, symbol in routes.items():
            got = ops._launch(a, b, m, symbol).float()
            torch.cuda.synchronize()
            over = float(((got - want).abs() / tol.clamp_min(1e-30)).max())
            if over > 1.0 or not bool((got[:, m == 0] == 0).all()):
                raise AssertionError(f"masked_matmul {label} route at M={M}"
                                     f" disagrees with its plain version "
                                     f"({over} of the tolerance)")
            row[f"{label}_ms"] = time_ms(
                lambda: ops._launch(a, b, m, symbol))
            row[f"{label}_err_over_tol"] = over
        row["library_ms"] = time_ms(lambda: torch.matmul(a, b) * m)
        print("crossover " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def launch_host_us(K: int, N: int, K32: int, N32: int, calls: int = 200):
    """Host time of one call (enqueue only: the card is faster than the
    host at these shapes, so no call waits; median of 5 batches of
    ``calls``) of the bf16 decode GEMV's wrapper at (1, K) @ (K, N), and of
    the float32 GEMV's and codes GEMV's wrappers and ``matmul * mask`` at
    (1, K32) @ (K32, N32) (dense14's compacted shape); and the time of the
    symbol lookup and ``argtypes`` assignment that ``build.launch`` does
    once per entry instead of on every call."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.masked_matmul import ops

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            samples.append(1e6 * (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
        return statistics.median(samples)
    a = torch.randn(1, K, device="cuda").to(torch.bfloat16)
    b = torch.randn(K, N, device="cuda").to(torch.bfloat16)
    m = torch.ones(N, device="cuda")
    a32 = torch.randn(1, K32, device="cuda")
    b32 = torch.randn(K32, N32, device="cuda")
    codes = torch.randint(0, 256, (K32, N32), device="cuda",
                          dtype=torch.uint8)
    scale, zero = torch.rand(N32, device="cuda"), torch.rand(N32,
                                                             device="cuda")
    m32 = torch.ones(N32, device="cuda")
    row = {"wrapper_call_host_us": host_us(
               lambda: ops.masked_matmul(a, b, m)),
           "f32_gemv_call_host_us": host_us(
               lambda: ops.masked_matmul(a32, b32, m32)),
           "q8_gemv_call_host_us": host_us(
               lambda: ops.masked_matmul_q8(a32, codes, scale, zero, m32)),
           "matmul_times_mask_host_us": host_us(
               lambda: matmul_times_mask(a32, b32, m32))}
    lib = build.load("masked_matmul")
    t0 = time.perf_counter()
    for _ in range(20 * calls):
        fn = getattr(lib, ops._ENTRIES["gemv"])
        fn.argtypes = [*ops._ARGTYPES, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    row["per_call_lookup_removed_us"] = (1e6 * (time.perf_counter() - t0)
                                         / (20 * calls))
    print("host " + json.dumps(row), flush=True)
    return row


def check_rmsnorm(cases):
    """Phase 3: the rmsnorm kernel against its plain version at each
    (name, rows, d, dtype, scale_offset)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import _plan, rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    eps32 = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for name, R, d, dtype, offset in cases:
        dt = getattr(torch, dtype)
        x = (3 * torch.randn(R, d, device="cuda", generator=gen)).to(dt)
        scale = (1 + 0.1 * torch.randn(d, device="cuda",
                                       generator=gen)).to(dt)
        got = rmsnorm(x, scale, 1e-6, offset)
        torch.cuda.synchronize()
        want = rmsnorm_ref(x, scale, 1e-6, offset).float()
        # tolerance: the two float32 sums of d squares in other orders
        # differ by at most d·eps relative, rsqrt against 1/sqrt and the two
        # products by a few eps more: (d/2 + 4)·eps·|y| after the root; a
        # bf16 output adds one bf16 spacing of the value
        tol = (d / 2 + 4) * eps32 * want.abs()
        if dtype == "bfloat16":
            tol = tol + BF16_SPACING * (want.abs() + tol)
        err = (got.float() - want).abs()
        ok = bool((err <= tol).all()) and got.dtype == dt
        w = scale + offset      # the library call takes the offset folded in
        row = {"case": name, "dtype": dtype, "rows": R, "d": d,
               "scale_offset": offset, "plan": _plan(R, d, dt),
               "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
               "ok": ok,
               "ms": time_ms(lambda: rmsnorm(x, scale, 1e-6, offset)),
               "plain_ms": time_ms(lambda: rmsnorm_ref(x, scale, 1e-6,
                                                       offset)),
               "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
               "device_ms": graph_ms(
                   lambda x, scale: rmsnorm(x, scale, 1e-6, offset),
                   x, scale),
               "library_device_ms": graph_ms(
                   lambda x, w: F.rms_norm(x, (d,), w, 1e-6), x, w)}
        # x read and y written once, the scale read once; about 4
        # operations an element (square-add, then two multiplies)
        set_bound(row, x.element_size() * (2 * R * d + d), 4 * R * d,
                  PEAK_FP32_FLOP_S)
        row["ok"] = ok = ok and hold_to_bound(row)
        rows.append(check_row("rmsnorm", row, ok))
    return rows


def check_gated_rmsnorm(cases, eps: float = 1e-6):
    """Phase 3: the rmsnorm kernel's gated entry against its plain version
    at each (name, rows, d, row stride of z, z's first column, dtype): z a
    slice of a (rows, ld) projection, as the Mamba2 block hands it in (ld =
    d and column 0: contiguous), x contiguous. ``library_ms`` is a
    composite of several calls (``F.rms_norm`` of ``x * silu(z)``): no one
    PyTorch call computes the gated norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import _plan, gated_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import gated_rmsnorm_ref
    eps32 = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def composite(x, z, scale):
        return F.rms_norm(x.float() * F.silu(z.float()), (x.shape[-1],),
                          scale.float(), eps).to(x.dtype)
    rows = []
    for name, R, d, ld, col, dtype in cases:
        dt = getattr(torch, dtype)
        x = torch.randn(R, d, device="cuda", generator=gen).to(dt)
        proj = (3 * torch.randn(R, ld, device="cuda", generator=gen)).to(dt)
        z = proj[:, col:col + d]
        scale = (1 + 0.1 * torch.randn(d, device="cuda",
                                       generator=gen)).to(dt)
        got = gated_rmsnorm(x, z, scale, eps)
        torch.cuda.synchronize()
        want = gated_rmsnorm_ref(x, z, scale, eps).float()
        # tolerance: the plain entry's (d/2 + 4)·eps·|y| (the two float32
        # sums of d squares in other orders, the root and the products),
        # plus 8 eps for the gate: expf within 2 ulp, 1 + e, the sigmoid's
        # division and the two products of g, each within half an ulp, and
        # the output's division; a bf16 output adds one bf16 spacing
        tol = (d / 2 + 12) * eps32 * want.abs()
        if dtype == "bfloat16":
            tol = tol + BF16_SPACING * (want.abs() + tol)
        err = (got.float() - want).abs()
        ok = (bool((err <= tol).all()) and got.dtype == dt
              and bool(torch.isfinite(got).all()))
        w = x.element_size()
        aligned = not (x.data_ptr() | z.data_ptr()) % 16 and not ld % (16 // w)
        row = {"case": name, "dtype": dtype, "rows": R, "d": d, "ldz": ld,
               "z_col": col, "plan": _plan(R, d, dt, aligned, gated=True),
               "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
               "ok": ok,
               "ms": time_ms(lambda: gated_rmsnorm(x, z, scale, eps)),
               "plain_ms": time_ms(lambda: gated_rmsnorm_ref(x, z, scale,
                                                             eps)),
               "library": "composite: F.rms_norm(x.float() * F.silu("
                          "z.float()), (d,), scale.float(), eps).to(x.dtype)",
               "library_ms": time_ms(lambda: composite(x, z, scale)),
               "device_ms": graph_ms(
                   lambda x, z, scale: gated_rmsnorm(x, z, scale, eps),
                   x, z, scale),
               "library_device_ms": graph_ms(composite, x, z, scale)}
        # x's and z's d columns read and y written once, the scale read
        # once; about 12 operations an element (the gate's exp, two
        # divisions, add and products; the square-add; the division and
        # the product by the scale)
        set_bound(row, w * (3 * R * d + d), 12 * R * d, PEAK_FP32_FLOP_S)
        row["ok"] = ok = ok and hold_to_bound(row)
        rows.append(check_row("rmsnorm_gated", row, ok))
    return rows


def check_gated_split(cases, eps: float = 1e-6):
    """Phase 3: the rmsnorm kernel's two split entries (the gated norm of
    a row split over "model" ranks) against their plain twins at each
    (name, rows, d, row stride of z, dtype, width): x contiguous, z the
    first d columns of a (rows, ld) projection (a rank's, as its Mamba2
    block hands it in: ld = 901 at Mamba2-2.7B on 16 ranks, the scalar
    route). The sum-of-squares entry's fp32 row sums within (d + 12) eps
    of each sum (d squares added in another order); the normalize entry,
    given the same whole-row sums (``width`` / d times the rank's), within
    16 eps of each output (the gate as the gated entry's, the root and the
    division) plus a bf16 spacing. No single PyTorch call computes
    either: ``library_ms`` null. Returns (sumsq rows, stat rows)."""
    import torch
    from repro_torch.kernels.rmsnorm.ops import (_plan, gated_rmsnorm_stat,
                                                 gated_sumsq)
    from repro_torch.kernels.rmsnorm.ref import (gated_rmsnorm_stat_ref,
                                                 gated_sumsq_ref)
    eps32 = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    sums, stats = [], []
    for name, R, d, ld, dtype, width in cases:
        dt = getattr(torch, dtype)
        x = torch.randn(R, d, device="cuda", generator=gen).to(dt)
        proj = (3 * torch.randn(R, ld, device="cuda", generator=gen)).to(dt)
        z = proj[:, :d]
        scale = (1 + 0.1 * torch.randn(d, device="cuda",
                                       generator=gen)).to(dt)
        w = x.element_size()
        aligned = not (x.data_ptr() | z.data_ptr()) % 16 and not ld % (16 // w)
        base = {"dtype": dtype, "rows": R, "d": d, "ldz": ld, "width": width,
                "plan": _plan(R, d, dt, aligned, gated=True)[:2]}
        got = gated_sumsq(x, z)
        torch.cuda.synchronize()
        want = gated_sumsq_ref(x, z)
        err = (got - want).abs()
        tol = (d + 12) * eps32 * want.abs()
        ok = (bool((err <= tol).all()) and got.dtype == torch.float32
              and tuple(got.shape) == (R,))
        row = {"case": f"{name} sumsq", **base,
               "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
               "ms": time_ms(lambda: gated_sumsq(x, z)),
               "plain_ms": time_ms(lambda: gated_sumsq_ref(x, z)),
               "library_ms": None,
               "device_ms": graph_ms(gated_sumsq, x, z)}
        # x's and z's d columns read, the sums written; about 11
        # operations an element (the gate's exp, divisions and products,
        # the square-add)
        set_bound(row, w * 2 * R * d + 4 * R, 11 * R * d, PEAK_FP32_FLOP_S)
        row["ok"] = ok = ok and hold_to_bound(row)
        sums.append(check_row("rmsnorm_gated_sumsq", row, ok))
        ss = want * (width / d)
        got = gated_rmsnorm_stat(x, z, scale, ss, width, eps)
        torch.cuda.synchronize()
        want = gated_rmsnorm_stat_ref(x, z, scale, ss, width, eps).float()
        tol = 16 * eps32 * want.abs()
        if dtype == "bfloat16":
            tol = tol + BF16_SPACING * (want.abs() + tol)
        err = (got.float() - want).abs()
        ok = (bool((err <= tol).all()) and got.dtype == dt
              and bool(torch.isfinite(got).all()))
        row = {"case": f"{name} stat", **base,
               "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
               "ms": time_ms(lambda: gated_rmsnorm_stat(x, z, scale, ss,
                                                        width, eps)),
               "plain_ms": time_ms(lambda: gated_rmsnorm_stat_ref(
                   x, z, scale, ss, width, eps)),
               "library_ms": None,
               "device_ms": graph_ms(
                   lambda x, z, scale, ss: gated_rmsnorm_stat(
                       x, z, scale, ss, width, eps), x, z, scale, ss)}
        # x's and z's columns and the sums read, y written, the scale read
        # once; about 12 operations an element
        set_bound(row, w * (3 * R * d + d) + 4 * R, 12 * R * d,
                  PEAK_FP32_FLOP_S)
        row["ok"] = ok = ok and hold_to_bound(row)
        stats.append(check_row("rmsnorm_gated_stat", row, ok))
    return sums, stats


def rmsnorm_plans(cases, eps: float = 1e-6):
    """Phase 3: the device time of each launch plan the kernel can take at
    (name, rows, d, gated): every threads-a-row of ``ops.ROW_THREADS``
    with the fewest slots a lane that covers the row, on the vector route,
    bf16, against the plan ``_plan`` picks. One ``plans`` line each."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    dt = torch.bfloat16
    for name, R, d, gated in cases:
        x = torch.randn(R, d, device="cuda", generator=gen).to(dt)
        z = torch.randn(R, d, device="cuda", generator=gen).to(dt)
        scale = torch.ones(d, device="cuda", dtype=dt)
        most = ops.GATED_MOST[dt] if gated else ops.LANE_SLOTS[-1]
        times = {}
        for tpr in ops.ROW_THREADS:
            per_lane = -(-d // (8 * tpr))
            if per_lane > most:
                continue
            plan = (8, tpr, next(n for n in ops.LANE_SLOTS if n >= per_lane))

            def run(x, z, scale, plan=plan):
                y = torch.empty_like(x)
                if gated:
                    build.launch("rmsnorm", ops._ENTRIES[True, dt],
                                 ops._GATED_ARGTYPES, x.device, x.data_ptr(),
                                 z.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                 R, d, d, d, eps, *plan)
                else:
                    build.launch("rmsnorm", ops._ENTRIES[False, dt],
                                 ops._ARGTYPES, x.device, x.data_ptr(),
                                 scale.data_ptr(), y.data_ptr(), R, d, eps,
                                 0.0, *plan)
                return y
            times[str(list(plan))] = graph_ms(run, x, z, scale)
        print("plans " + json.dumps(
            {"case": name, "rows": R, "d": d, "gated": gated,
             "picked": list(ops._plan(R, d, dt, True, gated)),
             "device_ms": times}), flush=True)


def attention_pairs(Sq: int, Sk: int, causal: bool, window,
                    q_offset: int = 0) -> int:
    """How many (query, key) pairs the mask lets through, query row i at
    key position ``q_offset + i``."""
    import numpy as np
    d = (np.arange(q_offset, q_offset + Sq)[:, None]
         - np.arange(Sk)[None, :])
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return int(ok.sum())


def check_flash(cases):
    """Phase 3: the flash kernel against its plain version at each (name,
    B, S, H, Hkv, D, causal, window, dtype[, q_offset]): S keys and S -
    q_offset queries, query row i at key position q_offset + i (a
    sequence block's queries against the keys of every position before
    them); its device time from a CUDA graph (``graph_ms``) held to the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    eps32 = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    with exact_fp32():
        for name, B, S, H, Hkv, D, causal, window, dtype, *rest in cases:
            off = rest[0] if rest else 0
            kw = dict(causal=causal, window=window, q_offset=off)
            dt = getattr(torch, dtype)
            q = torch.randn(B, S - off, H, D, device="cuda",
                            generator=gen).to(dt)
            k = torch.randn(B, S, Hkv, D, device="cuda", generator=gen).to(dt)
            v = torch.randn(B, S, Hkv, D, device="cuda", generator=gen).to(dt)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = attention_ref(q, k, v, **kw).float()
            # tolerance: two float32 evaluations of the same softmax-
            # weighted sum (online over tiles against materialised) differ
            # by roundoff in the scores, exponentials and sums, a few eps
            # of max|v| an output; 64 eps of it leaves a wide margin. The
            # bf16 kernel rounds P to bf16 before P V (at most 2**-8 of
            # each weight, so 2**-8 * max|v| an output, l summed from the
            # fp32 P), and its output adds one bf16 spacing of the value
            vmax = float(v.float().abs().max())
            tol = torch.full_like(want, 64 * eps32 * vmax)
            if dtype == "bfloat16":
                tol = tol + 2.0 ** -8 * vmax
                tol = tol + BF16_SPACING * (want.abs() + tol)
            err = (got.float() - want).abs()
            ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
            # the library call: one scaled_dot_product_attention on the
            # (B, H, S, D) views, GQA by its own head grouping, the window
            # or the offset's diagonal as a boolean mask
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = None
            if window is not None or off:
                dd = (torch.arange(off, S, device="cuda")[:, None]
                      - torch.arange(S, device="cuda")[None, :])
                mask = (dd < window if window is not None
                        else torch.ones_like(dd, dtype=torch.bool))
                if causal:
                    mask &= dd >= 0

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)
            row = {"case": name, "dtype": dtype, "B": B, "S": S, "H": H,
                   "Hkv": Hkv, "D": D, "causal": causal, "window": window,
                   "q_offset": off,
                   "max_abs_err": float(err.max()),
                   "max_err_over_tol": float((err / tol.clamp_min(1e-30))
                                             .max()),
                   "ok": ok,
                   "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
                   "plain_ms": time_ms(lambda: attention_ref(q, k, v, **kw)),
                   "library_ms": time_ms(library),
                   "device_ms": graph_ms(
                       lambda q, k, v: flash_attention(q, k, v, **kw),
                       q, k, v)}
            # q, k, v read and the output written once; Q K^T and P V at 2
            # operations a multiply-add over the pairs the mask lets through
            pairs = attention_pairs(S - off, S, causal, window, off)
            set_bound(row, q.element_size() * (2 * q.numel() + 2 * k.numel()),
                      4 * B * H * D * pairs,
                      PEAK_FP32_FLOP_S if dtype == "float32"
                      else PEAK_BF16_FLOP_S)
            row["ok"] = ok = ok and hold_to_bound(row)
            rows.append(check_row("flash_attention", row, ok))
            del q, k, v, got, want, tol, err
    return rows


def ssd_inputs(B: int, S: int, H: int, G: int, P: int, N: int, dtype: str,
               gen):
    """The scan's inputs as the Mamba2 block hands them in: x, B and C as
    slices of one (B, S, H*P + 2*G*N) conv output in ``dtype``; dt =
    softplus(u + dt_bias) in float32 with u normal and dt_bias the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1] per head; A = -linspace(1,
    16, H), the reference's init, so that the fast heads decay by up to
    e^-16 a step and exp above the decay matrix's diagonal overflows."""
    import math
    import torch
    import torch.nn.functional as F
    dt_ = getattr(torch, dtype)
    xBC = torch.randn(B, S, H * P + 2 * G * N, device="cuda",
                      generator=gen).to(dt_)
    xh = xBC[..., :H * P].reshape(B, S, H, P)
    Bm = xBC[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xBC[..., H * P + G * N:].reshape(B, S, G, N)
    u = torch.rand(H, device="cuda", generator=gen)
    d0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    bias = d0 + torch.log(-torch.expm1(-d0))
    dt = F.softplus(torch.randn(B, S, H, device="cuda", generator=gen)
                    + bias)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    return xh, dt, A, Bm, Cm


def ssd_tolerance(xh, dt, A, Bm, Cm, chunk: int):
    """Elementwise bounds (on y, on the final state) between two float32
    evaluations of the chunked SSD scan that sum in other orders or walk
    other chunk lengths up to ``chunk`` (the kernel 64, the plain version
    256). Every output is a sum of products of x, B, C, step sizes and
    decay factors in [0, 1]; the plain version on |x|, |B|, |C| gives the
    sum of their magnitudes, M. A float32 dot product of length n errs by at
    most n·eps/2·M: the lengths are N (C·B), the chunk (W·x and the chunk's
    state) and the number of chunks (the carried state); the decay
    exponents are differences of within-chunk cumulative sums, rounded by
    eps·|cs| at most, which is the relative error of their exp: so
    (N + chunk + n_chunks + 2·max|cs|)·eps·M."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    S, N = xh.shape[1], Bm.shape[3]
    Q = max(1, min(chunk, S))
    mag_y, mag_s = ssd_chunked(xh.float().abs(), dt, A, Bm.float().abs(),
                               Cm.float().abs(), Q)
    nc = -(-S // Q)
    da = F.pad(dt * A.abs(), (0, 0, 0, nc * Q - S))
    cs_max = float(da.reshape(da.shape[0], nc, Q, -1).sum(2).max())
    k = (N + Q + nc + 2 * cs_max) * EPS32
    return k * mag_y, k * mag_s


def ssd_bound(row, B, S, H, G, P, N, itemsize, kept_heads, chunk=256):
    """Bytes: x, B, C, dt, A and the head mask read once, y and the float32
    state written once. Operations, at the reference's chunk: per chunk of
    q steps, the causal half of C·B^T (q(q+1)/2·N multiply-adds) and of W·x
    (q(q+1)/2·P), C·state^T and the state update (q·P·N each) for a kept
    head; only the state update for a pruned one (its y is zeros, its state
    is still written). At the peak of the inputs' type."""
    nbytes = (itemsize * (2 * B * S * H * P + 2 * B * S * G * N)
              + 4 * (B * S * H + 2 * H + B * H * P * N))
    mac_kept = mac_pruned = 0
    for s0 in range(0, S, chunk):
        q = min(chunk, S - s0)
        mac_kept += q * (q + 1) // 2 * (N + P) + 2 * q * P * N
        mac_pruned += q * P * N
    flops = 2 * B * (kept_heads * mac_kept + (H - kept_heads) * mac_pruned)
    return set_bound(row, nbytes, flops, PEAK_FP32_FLOP_S if itemsize == 4
                     else PEAK_BF16_FLOP_S)


def check_ssd(cases, profile_cases=()):
    """Phase 3: the SSD scan kernel against its plain version at each (name,
    B, S, H, G, P, N, dtype, mask), mask one of "half" (a random half of the
    heads pruned, as the main path's ratio-0.5 masks), "none", "zeros"
    (every head pruned): y and the final state, pruned heads' y exact
    zeros. No PyTorch call computes the SSD scan, so ``library_ms`` is
    null. The cases named in ``profile_cases`` also give each launch's
    device time (``passes_ms``)."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = []
    with exact_fp32():
        for name, B, S, H, G, P, N, dtype, kind in cases:
            xh, dt, A, Bm, Cm = ssd_inputs(B, S, H, G, P, N, dtype, gen)
            hm = {"half": (torch.randperm(H, device="cuda", generator=gen)
                           < H // 2).float(),
                  "none": torch.ones(H, device="cuda"),
                  "zeros": torch.zeros(H, device="cuda")}[kind]
            got_y, got_s = ssd_scan(xh, dt, A, Bm, Cm, hm, 256)
            torch.cuda.synchronize()
            want_y, want_s = ssd_chunked(xh, dt, A, Bm, Cm, min(256, S))
            want_y = want_y * hm[None, None, :, None]
            tol_y, tol_s = ssd_tolerance(xh, dt, A, Bm, Cm, 256)
            tol_y = tol_y * hm[None, None, :, None]
            if dtype == "bfloat16":
                tol_y = tol_y + BF16_SPACING * (want_y.abs() + tol_y)
            err_y = (got_y.float() - want_y).abs()
            err_s = (got_s - want_s).abs()
            pruned_exact = bool((got_y[:, :, hm == 0] == 0).all())
            ok = (bool((err_y <= tol_y).all()) and bool((err_s <= tol_s).all())
                  and pruned_exact and got_y.dtype == xh.dtype
                  and bool(torch.isfinite(got_y).all()))
            over = max(float((err_y / tol_y.clamp_min(1e-30)).max()),
                       float((err_s / tol_s.clamp_min(1e-30)).max()))
            row = {"case": name, "dtype": dtype, "B": B, "S": S, "H": H,
                   "G": G, "P": P, "N": N, "mask": kind,
                   "kept_heads": int(hm.sum()),
                   "max_abs_err": max(float(err_y.max()), float(err_s.max())),
                   "max_abs_err_state": float(err_s.max()),
                   "max_err_over_tol": over,
                   "pruned_exact_zero": pruned_exact, "ok": ok,
                   "ms": time_ms(lambda: ssd_scan(xh, dt, A, Bm, Cm, hm,
                                                  256)),
                   "device_ms": graph_ms(ssd_scan, xh, dt, A, Bm, Cm, hm),
                   "plain_ms": time_ms(lambda: ssd_scan_ref(
                       xh, dt, A, Bm, Cm, hm, 256)),
                   "library_ms": None}
            if name in profile_cases:
                # device ms of each launch of one call, by kernel
                prof = device_profile(lambda: (ssd_scan(xh, dt, A, Bm, Cm,
                                                        hm, 256),
                                               torch.cuda.synchronize()))
                row["passes_ms"] = {
                    re.search(r"ssd_\w+_kernel", e["name"]).group(0):
                    e["device_ms"] for e in prof["top"] if "ssd_" in e["name"]}
            ssd_bound(row, B, S, H, G, P, N, xh.element_size(),
                      row["kept_heads"])
            row["ok"] = ok = ok and hold_to_bound(row)
            rows.append(check_row("ssd_scan", row, ok))
            del xh, dt, Bm, Cm, got_y, got_s, want_y, want_s, tol_y, tol_s
    return rows


def rel_gap(got, want) -> float:
    """Relative L2 gap of ``got`` to ``want`` (the largest |got| where
    ``want`` is all zeros)."""
    norm = float(want.double().norm())
    diff = got.double() - want.double()
    return float(diff.norm()) / norm if norm else float(diff.abs().max())


def grads_of(fn, operands, g, *rest):
    """Gradients of ``fn(*operands, *rest)`` (its first output, if a
    tuple) for the output gradient ``g``, by autograd."""
    import torch
    ins = [t.detach().requires_grad_(True) for t in operands]
    out = fn(*ins, *rest)
    out = out[0] if isinstance(out, tuple) else out
    return torch.autograd.grad(out, ins, g.to(out.dtype))


def hold_grads(kernel, plain32, plain64, names, dtypes):
    """Each gradient's relative L2 gap to the float64 plain autograd,
    within twice the float32 plain autograd's (rounded to the operand's
    dtype) plus one bf16 spacing for a bf16 operand, 64 eps for a float32
    one. Returns ({name: {gap, plain_gap, tol}}, worst gap over tol)."""
    import torch
    out, worst = {}, 0.0
    for name, k, p, w, dt in zip(names, kernel, plain32, plain64, dtypes):
        gap_k = rel_gap(k, w)
        gap_p = rel_gap(p.to(dt), w)
        tol = 2 * gap_p + (BF16_SPACING if dt == torch.bfloat16
                           else 64 * EPS32)
        out[name] = {"gap": gap_k, "plain_gap": gap_p, "tol": tol,
                     "finite": bool(torch.isfinite(k).all())}
        worst = max(worst, gap_k / tol if out[name]["finite"]
                    else float("inf"))
    return out, worst


def check_ssd_grads(cases):
    """Phase 3: ``ssd_scan`` as its autograd Function on the card (the
    kernels' forward, ``ssd_scan_backward`` in PyTorch ops) against
    autograd through the plain version, at each (name, B, S, H, G, P, N):
    bf16 x, B and C sliced from one conv output, a random half of the
    heads pruned, a random bf16 dy, the final state unused (as in
    training). Yardstick: the plain version's autograd in float64 on the
    same values (``hold_grads``); pruned heads' dx and ddt exact zeros;
    ``backward_ms`` one ``ssd_scan_backward`` call (TF32 off)."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_backward
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = []
    with exact_fp32():
        for name, B, S, H, G, P, N in cases:
            ops = ssd_inputs(B, S, H, G, P, N, "bfloat16", gen)
            hm = (torch.randperm(H, device="cuda", generator=gen)
                  < H // 2).float()
            dy = torch.randn(B, S, H, P, device="cuda",
                             generator=gen).to(torch.bfloat16)
            got = grads_of(ssd_scan, ops, dy, hm, 256)
            torch.cuda.synchronize()
            p32 = grads_of(ssd_scan_ref, [t.float() for t in ops], dy, hm,
                           256)
            p64 = grads_of(ssd_scan_ref, [t.double() for t in ops], dy,
                           hm.double(), 256)
            gaps, worst = hold_grads(got, p32, p64, ("x", "dt", "A", "B",
                                                     "C"),
                                     [t.dtype for t in ops])
            del p32, p64
            pruned = hm == 0
            exact = bool((got[0][:, :, pruned] == 0).all()
                         and (got[1][:, :, pruned] == 0).all())
            ok = worst <= 1.0 and exact
            row = {"case": name, "B": B, "S": S, "H": H, "G": G, "P": P,
                   "N": N, "dtype": "bfloat16", "kept_heads": int(hm.sum()),
                   "grads": gaps, "max_gap_over_tol": worst,
                   "pruned_exact_zero": exact,
                   "tol": "relative L2 gap to the float64 plain autograd "
                          "<= 2 x the float32 plain autograd's + 2^-7 "
                          "(bf16 x, B, C) or 64 eps (float32 dt, A)",
                   "backward_ms": time_ms(lambda: ssd_scan_backward(
                       *ops, hm, dy, None, 256), reps=5, rounds=3),
                   "ok": ok}
            print("kernel_grad ssd_scan " + json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"ssd_scan's Function at {name}: "
                                     f"{json.dumps(row)}")
            rows.append(row)
            del ops, got, dy
    torch.cuda.empty_cache()
    return rows


def check_gated_grads(cases, eps: float = 1e-6):
    """Phase 3: ``gated_rmsnorm`` as its autograd Function on the card (the
    gated entry's forward, z read in place; ``gated_rmsnorm_backward``)
    against autograd through the plain version at each (name, rows, d,
    projection width): bf16 x, z the first d columns of a (rows, width)
    projection, whose gradient autograd carries into the slice, scale near
    1, a random bf16 g. Held as ``check_ssd_grads``; ``backward_ms`` one
    ``gated_rmsnorm_backward`` call."""
    import torch
    from repro_torch.kernels.rmsnorm.ops import (gated_rmsnorm,
                                                 gated_rmsnorm_backward)
    from repro_torch.kernels.rmsnorm.ref import gated_rmsnorm_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for name, R, d, ld in cases:
        bf = torch.bfloat16
        x = torch.randn(R, d, device="cuda", generator=gen).to(bf)
        proj = (3 * torch.randn(R, ld, device="cuda", generator=gen)).to(bf)
        scale = (1 + 0.1 * torch.randn(d, device="cuda",
                                       generator=gen)).to(bf)
        g = torch.randn(R, d, device="cuda", generator=gen).to(bf)

        def sliced(norm):
            return lambda x, p, s: norm(x, p[:, :d], s, eps)
        ops = (x, proj, scale)
        got = grads_of(sliced(gated_rmsnorm), ops, g)
        torch.cuda.synchronize()
        p32 = grads_of(sliced(gated_rmsnorm_ref), [t.float() for t in ops], g)
        p64 = grads_of(sliced(gated_rmsnorm_ref), [t.double() for t in ops],
                       g)
        gaps, worst = hold_grads(got, p32, p64, ("x", "proj", "scale"),
                                 [bf] * 3)
        untouched = bool((got[1][:, d:] == 0).all())
        ok = worst <= 1.0 and untouched
        row = {"case": name, "rows": R, "d": d, "ldz": ld,
               "dtype": "bfloat16", "grads": gaps,
               "max_gap_over_tol": worst, "rest_of_proj_zero": untouched,
               "tol": "relative L2 gap to the float64 plain autograd <= 2 x "
                      "the float32 plain autograd's + 2^-7",
               "backward_ms": time_ms(lambda: gated_rmsnorm_backward(
                   x, proj[:, :d], scale, g, eps), reps=5, rounds=3),
               "ok": ok}
        print("kernel_grad rmsnorm_gated " + json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(f"gated_rmsnorm's Function at {name}: "
                                 f"{json.dumps(row)}")
        rows.append(row)
        del x, proj, scale, g, got, p32, p64
    torch.cuda.empty_cache()
    return rows


def half_masks(cfg, params, rng):
    """Keep a random half of each prunable layer's channels."""
    import numpy as np
    from repro_torch.models.cnn import prunable_layers
    masks = {}
    for i in prunable_layers(cfg):
        n = params[f"l{i}"]["b"].shape[0]
        m = np.zeros(n, np.float32)
        m[rng.permutation(n)[:n // 2]] = 1.0
        masks[i] = m
    return masks


def logit_tolerance(plan):
    """-> a function giving, per request image, the elementwise bound on
    |logits(card) - logits(CPU)|.

    Both devices run the same plan with GEMMs and convs that sum in
    different orders, which moves the logits by far less than 1e-3 of the
    largest one (the fp32 part). At an interior split the int8 codec may
    also round one side's boundary element one step (the frame's scale)
    away from the other's; ``cnn_abs_bound`` carries a one-step change of
    every element through the cloud half (the codec part)."""
    import numpy as np
    import torch
    from repro_torch.core.collab.runtime import deploy_submodels
    from repro_torch.core.collab.protocol import affine_qparams
    from repro_torch.core.collab.quant import quant_cnn_apply, quantize_params
    from repro_torch.device import exact_fp32
    from repro_torch.models.cnn import cnn_abs_bound, masks_to, oihw_params

    def fp32_part(logits):
        return 1e-3 * max(1.0, float(np.abs(logits).max()))

    n = len(plan.cfg.layers)
    if plan.split in (0, n) or plan.codec != "int8":
        return lambda image, logits: fp32_part(logits)
    dev = torch.device("cuda")
    dparams, dcfg, dmasks = deploy_submodels(plan.params, plan.cfg,
                                             plan.masks, plan.compact)
    dparams = {k: {leaf: t.to(dev) for leaf, t in v.items()}
               for k, v in dparams.items()}
    masks = masks_to(dmasks, dev)
    q = quantize_params(dparams, dcfg, plan.quant)
    tparams = oihw_params(dparams, dcfg)

    def tolerance(image, logits):
        with torch.inference_mode(), exact_fp32():
            feat = quant_cnn_apply(q, dcfg, torch.from_numpy(image).to(dev),
                                   masks=masks, stop_layer=plan.split,
                                   backend="ref")
            step, _ = affine_qparams(float(feat.min()), float(feat.max()),
                                     255)
            codec = cnn_abs_bound(tparams, dcfg, torch.full_like(feat, step),
                                  masks=masks, start_layer=plan.split)
        return fp32_part(logits) + codec.cpu().numpy()
    return tolerance


def serve_path(label, plan, images, edge_gemms):
    """Phase 4 for one plan: serve on the card with the launch counter
    read around the run, then the same requests on the CPU."""
    import numpy as np
    from repro_torch import serving
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    sess = serving.connect(plan, backend="local")        # the card
    masked_matmul.launches = 0
    masked_matmul.route_launches = dict.fromkeys(
        masked_matmul.route_launches, 0)
    got = sess.infer_many(images)
    launches = masked_matmul.launches
    routes = {k: v for k, v in masked_matmul.route_launches.items() if v}
    want_routes = {k: v * len(images) for k, v in edge_routes(plan).items()}
    if routes != want_routes:
        raise AssertionError(f"{label}: masked_matmul routes {routes}, "
                             f"expected {want_routes}")
    want_launches = edge_gemms * len(images)
    cpu = serving.connect(plan, backend="local", device="cpu")
    want = cpu.infer_many(images)
    tolerance = logit_tolerance(plan)
    worst = 0.0
    for img, g, w in zip(images, got, want):
        lg, lw = g["logits"], w["logits"]
        if not (lg.shape == lw.shape and np.isfinite(lg).all()):
            raise AssertionError(f"{label}: bad logits {lg.shape}")
        if g["tx_bytes"] != w["tx_bytes"]:
            raise AssertionError(f"{label}: tx_bytes {g['tx_bytes']} on "
                                 f"the card, {w['tx_bytes']} on the CPU")
        tol = tolerance(img, lw)
        gap = np.abs(lg - lw)
        worst = max(worst, float((gap / tol).max()))
        if not (gap <= tol).all() or \
                lg.argmax(-1).tolist() != lw.argmax(-1).tolist():
            raise AssertionError(f"{label}: logits differ from the CPU "
                                 f"path by {gap.max()} (tolerance "
                                 f"{np.min(tol)})")
    if launches != want_launches:
        raise AssertionError(f"{label}: masked_matmul launched {launches} "
                             f"times, expected {want_launches}")
    edge_ms = [1e3 * r["wallclock"]["edge"] for r in got]
    cloud_ms = [1e3 * r["wallclock"]["cloud"] for r in got]
    row = {"path": label, "split": plan.split,
           "n_layers": len(plan.cfg.layers), "compact": plan.compact,
           "weight_bits": plan.quant.weight_bits,
           "requests": len(images), "launches": launches, "routes": routes,
           "tx_bytes": got[0]["tx_bytes"],
           "edge_ms": edge_ms, "cloud_ms": cloud_ms,
           "edge_ms_first": edge_ms[0],
           "edge_ms_median": statistics.median(edge_ms[1:]),
           "cloud_ms_median": statistics.median(cloud_ms[1:]),
           "t_edge_model_s": got[0]["t_edge"],
           "t_upstream_model_s": got[0]["t_upstream"],
           "max_gap_over_tol": worst}
    print("slice " + json.dumps(row), flush=True)
    return row


def edge_gemm_count(plan, split=None) -> int:
    """Conv and dense layers on the edge at ``split`` (the plan's)."""
    split = plan.split if split is None else split
    return sum(1 for s in plan.cfg.layers[:split]
               if s.kind in ("conv", "dense"))


def edge_routes(plan, split=None):
    """``masked_matmul`` launches of one request by entry: each edge conv
    and dense layer of the deployed (compacted or masked) network on the
    route its shape picks, from codes where the plan quantizes; at
    ``split`` (the plan's when None)."""
    import collections
    import torch
    from repro_torch.core.collab.runtime import deploy_submodels
    from repro_torch.kernels.masked_matmul.ops import _route
    _, dcfg, _ = deploy_submodels(plan.params, plan.cfg, plan.masks,
                                  plan.compact)
    dtype = torch.float32 if plan.quant.weight_bits is None else torch.uint8
    return collections.Counter(
        _route(dtype, M, K, N)
        for _, M, K, N in gemm_shapes(dcfg)[:edge_gemm_count(plan, split)])


#: device kernels grouped by a substring of their name: the port's own
#: kernels, cuBLAS's products, PyTorch's im2col, pooling, the MoE
#: dispatch's sort, top-k, histogram, scan, indexing (the gather and
#: scatter of rows; also a decode step's KV-cache writes) and softmax, and
#: elementwise and reduction kernels
KINDS = (("masked_matmul tiles", "masked_matmul_wgmma"),
         ("masked_matmul splitk", "masked_matmul_splitk"),
         ("masked_matmul gemv f32", "masked_matmul_gemv_f32"),
         ("masked_matmul gemv", "masked_matmul_gemv"),
         ("masked_matmul", "masked_matmul_kernel"),
         ("rmsnorm gated", "rmsnorm_gated_rows"), ("rmsnorm", "rmsnorm_rows"),
         ("flash_attention", "flash_kernel"),
         ("ssd_scan chunk states", "ssd_chunk_state"),
         ("ssd_scan state pass", "ssd_state_pass"),
         ("ssd_scan outputs", "ssd_chunk_out"), ("ssd_scan", "ssd_kernel"),
         ("cublas", "nvjet"), ("cublas", "gemm"), ("cublas", "gemv"),
         ("im2col", "im2col"), ("maxpool", "max_pool"),
         ("sort", "RadixSort"), ("sort", "radixSort"), ("topk", "TopK"),
         ("topk", "topk"), ("sort", "Sort"), ("histogram", "Histogram"), ("scan", "Scan"),
         ("scan", "scan"), ("index", "index"), ("index", "gather"),
         ("index", "scatter"), ("softmax", "softmax"), ("softmax", "SoftMax"),
         ("elementwise", "elementwise"), ("reduce", "reduce"),
         ("copy", "Memcpy"), ("copy", "copy"), ("cat", "Cat"))


def device_profile(fn):
    """Device time by kernel for one call of ``fn`` (which ends in a
    synchronize), against that call's unprofiled host wall-clock, after a
    warm-up call. The traced call is the second of one profiler session
    whose first call is its warm-up step: a session's first kernels
    (those launched while the tracer starts) can be missing from its
    trace. ``by_kind`` sums the device time over the groups of ``KINDS``
    (the first whose substring the name holds; "other" for the rest),
    ``count_by_kind`` the traced kernels; the session's step annotation
    (``ProfilerStep#``), which spans the call's kernels on the device
    too, is no kernel and is left out."""
    import torch
    fn()
    t0 = time.perf_counter()
    fn()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traced = []
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        for _ in range(2):
            fn()
            prof.step()
    events = [e for e in traced[-1]
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.device_time_total > 0
              and not e.key.startswith("ProfilerStep")]
    device_ms = sum(e.device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    by_kind, count_by_kind = {}, {}
    for e in events:
        kind = next((k for k, sub in KINDS if sub in e.key), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total / 1e3
        count_by_kind[kind] = count_by_kind.get(kind, 0) + e.count
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "by_kind": by_kind, "count_by_kind": count_by_kind,
            "top": [{"name": e.key[:60], "count": e.count,
                     "device_ms": e.device_time_total / 1e3} for e in top]}


def profile_request(plan, image):
    """Phase 5: where one full-width AlexNet request's device time goes."""
    from repro_torch import serving
    sess = serving.connect(plan, backend="local")
    print("profile " + json.dumps({"split": plan.split,
                                   **device_profile(lambda: sess.infer(image))}),
          flush=True)


# ---------------------------------------------------------------------------
# phases 6-7: the pruned Qwen2-7B served by prefill and greedy decode
# ---------------------------------------------------------------------------
def model_setup(cfg, seed: int):
    """``cfg`` at full width on the card: random weights from a seeded CUDA
    generator in the reference's distributions (``init_params`` draws one
    tensor at a time), then random norm scales near 1, QKV and conv biases
    and SSD skip weights ``D`` (the reference initialises them to ones and
    zeros, which would leave the scale, bias and skip paths untested), and
    masks from ``transformer_masks_from_ratios`` at ratio 0.5 on every unit:
    half the KV groups and FFN channels (or experts) of every attention
    (or MoE) layer, half the SSD heads of every Mamba2 layer. An MLA
    stack's latent norm scales (``q_norm``, ``kv_norm``) are drawn near 1
    too."""
    import torch
    from repro_torch.core.pruning.masks import (transformer_masks_from_ratios,
                                                transformer_prunable_units)
    from repro_torch.models import transformer as tr
    params = tr.init_params(cfg, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def fill(t, mean, std):
        t.copy_(mean + std * torch.randn(t.shape, device="cuda",
                                         generator=gen))
    for rp in params["runs"]:
        if "attn" in rp:
            for name in ("bq", "bk", "bv"):
                if name in rp["attn"]:
                    fill(rp["attn"][name], 0.0, 0.1)
            for name in ("q_norm", "kv_norm"):        # MLA's latent norms
                if name in rp["attn"]:
                    fill(rp["attn"][name], 1.0, 0.1)
            fill(rp["ln1"], 1.0, 0.1)
            fill(rp["ln2"], 1.0, 0.1)
        else:
            fill(rp["ln1"], 1.0, 0.1)
            fill(rp["ssm"]["norm_scale"], 1.0, 0.1)
            fill(rp["ssm"]["conv_b"], 0.0, 0.1)
            fill(rp["ssm"]["D"], 1.0, 0.1)
    if "shared" in params:
        fill(params["shared"]["ln1"], 1.0, 0.1)
        fill(params["shared"]["ln2"], 1.0, 0.1)
    fill(params["final_norm"], 1.0, 0.1)
    n = len(transformer_prunable_units(cfg))
    masks = transformer_masks_from_ratios(params, cfg, [0.5] * n)
    return params, masks


def describe(cfg, params, masks, of_layers=None, **extra) -> None:
    """The ``slice`` line naming the model being served; ``of_layers``,
    where depth was cut, the config's own layer count; ``extra`` keys
    added to the line as they are."""
    from repro_torch.models.transformer import param_count
    row = {"model": cfg.name, "arch_type": cfg.arch_type,
           "num_layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab_size": cfg.vocab_size, "dtype": cfg.dtype,
           "params": param_count(params)}
    if of_layers is not None:
        row["layers"] = f"{cfg.num_layers} of {of_layers}"
    if cfg.ssm is not None:
        row.update(ssm_heads=cfg.ssm_heads, ssm_head_dim=cfg.ssm.head_dim,
                   d_state=cfg.ssm.d_state, chunk_size=cfg.ssm.chunk_size,
                   kept_ssm_heads_per_layer=float(
                       masks[0]["ssm_head_mask"].sum(1)[0]))
    if cfg.num_heads:
        row.update(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                   shared_attn_period=cfg.shared_attn_period)
    if cfg.moe is not None:
        row.update(num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                   d_expert=cfg.moe.d_expert,
                   capacity_factor=cfg.moe.capacity_factor,
                   sliding_window=cfg.sliding_window,
                   num_shared=cfg.moe.num_shared, score_fn=cfg.moe.score_fn,
                   num_dense_layers=cfg.num_dense_layers)
    if cfg.mla is not None:
        row.update(attention="mla", mtp_depth=cfg.mtp_depth,
                   **dataclasses.asdict(cfg.mla))
    if cfg.vision_tokens or cfg.embeds_input:
        row.update(causal=cfg.causal, activation=cfg.activation,
                   rope_mode=cfg.rope_mode,
                   mrope_sections=list(cfg.mrope_sections),
                   vision_tokens=cfg.vision_tokens,
                   embeds_input=cfg.embeds_input)
    kept = {"head_mask": "kept_heads_per_layer",
            "ffn_mask": "kept_ffn_per_layer",
            "expert_mask": "kept_experts_per_layer"}
    for run_masks in masks:
        row.update({kept[axis]: float(m.sum(1)[0])
                    for axis, m in (run_masks or {}).items()
                    if axis in kept})
    row.update(extra)
    print("slice " + json.dumps(row), flush=True)


def card_batch(cfg, batch):
    """A request batch on the card in the types the stack reads, moved as
    the serving step moves it."""
    import torch
    from repro_torch.launch.steps import batch_on
    return batch_on(torch.device("cuda"), cfg, batch)


def serve_tokens(cfg, params, masks, batch, plain: bool = False,
                 forced=None, steps: int = DECODE_STEPS):
    """One request ``batch`` (``request_batches``): prefill, then
    DECODE_STEPS greedy decode steps (or, with ``forced``, the given
    tokens: teacher forcing); a bidirectional encoder's prefill alone,
    which gives every position's logits (``steps`` decode steps where
    given). The kernel path goes through the
    serving steps a launcher calls; ``plain`` calls the stack's plain
    versions on the card (``backend="ref"``), the yardstick. Returns every
    logit row (float32), the fed tokens and the host wall-clock of each
    step, each ending in a synchronize."""
    import torch
    from repro_torch.data.requests import batch_shape
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as tr
    B, S = batch_shape(cfg, batch)
    max_len = S + steps
    steps = steps if cfg.causal else 0
    if plain:
        def prefill(p, batch):
            return tr.prefill(p, cfg, card_batch(cfg, batch),
                              max_len=max_len, masks=masks, backend="ref")

        def decode(p, cache, tok):
            return tr.decode_step(p, cfg, cache, tok, masks=masks,
                                  backend="ref")
    else:
        prefill = make_prefill_step(cfg, max_len=max_len, masks=masks)
        decode = make_decode_step(cfg, masks=masks) if steps else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    logits, decode_ms = [lg.float()], []
    fed = [torch.zeros((B, 0), dtype=torch.long, device=lg.device)]
    for t in range(steps):
        nxt = (lg.argmax(-1, keepdim=True) if forced is None
               else forced[:, t:t + 1])
        fed.append(nxt)
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, nxt)
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(lg.float())
    return {"logits": logits, "tokens": torch.cat(fed, 1),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def transformer_wrappers():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.kernels.rmsnorm.ops import (gated_rmsnorm,
                                                 gated_rmsnorm_stat,
                                                 gated_sumsq, rmsnorm)
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    return {"rmsnorm": rmsnorm, "rmsnorm_gated": gated_rmsnorm,
            "rmsnorm_gated_sumsq": gated_sumsq,
            "rmsnorm_gated_stat": gated_rmsnorm_stat,
            "masked_matmul": masked_matmul,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan}


def gated_launches(n: int, split: bool = False) -> dict:
    """The gated norm's ``n`` launches by entry: the single entry's, or on
    a split of more than one "model" rank the two split entries' (the row
    sums of squares and the normalization, each ``n``)."""
    return {"rmsnorm_gated": 0 if split else n,
            "rmsnorm_gated_sumsq": n if split else 0,
            "rmsnorm_gated_stat": n if split else 0}


def zero_launches() -> None:
    """Every transformer wrapper's launch counter, and ``masked_matmul``'s
    by route, set to 0."""
    wrappers = transformer_wrappers()
    for w in wrappers.values():
        w.launches = 0
    mm = wrappers["masked_matmul"]
    mm.route_launches = dict.fromkeys(mm.route_launches, 0)


def read_launches() -> dict:
    """The transformer wrappers' launch counters, and ``masked_matmul``'s
    by route."""
    wrappers = transformer_wrappers()
    counts = {name: w.launches for name, w in wrappers.items()}
    counts.update(wrappers["masked_matmul"].route_launches)
    return counts


def expected_launches(cfg, steps: int = DECODE_STEPS, split: bool = False):
    """Kernel launches of one request (a prefill and ``steps`` decode
    steps) of ``cfg``'s pruned stack: an attention or MoE layer has two
    pre-norms and (prefill only) one flash attention, or, with MLA, two
    more norms (``q_norm``, ``kv_norm``) every step and no flash
    attention (MLA's is plain PyTorch); an attention layer (``attn``, or
    an MoE stack's dense ``attn_dense``) also the masked FFN's up and gate
    products (an MoE layer's experts are plain batched products); a
    Mamba2 layer one pre-norm, one gated norm and (prefill only) one scan;
    each invocation of a hybrid's shared block two norms and (prefill
    only) one attention, its MLP unmasked; the final norm once a step. The
    FFN products, by ``masked_matmul`` entry: the prefill's (M = B*S rows)
    on the wgmma tiles, the decode steps' (M = B) on the GEMV. A non-gated
    FFN (HuBERT's GELU) has one masked product, the up product; a
    bidirectional encoder serves its prefill alone. On a rank of a split
    over more than one "model" rank (``split``) a gated norm is the two
    split entries (``gated_launches``)."""
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.models.layers.mlp import GATED
    from repro_torch.models.transformer import hybrid_split, layer_runs
    decode = steps if cfg.causal else 0
    steps = 1 + decode
    attn = sum(r.count for r in layer_runs(cfg) if r.kind != "ssm")
    ffn = sum(r.count for r in layer_runs(cfg)
              if r.kind in ("attn", "attn_dense"))
    mla = attn if cfg.attention == "mla" else 0
    ssm = cfg.num_layers - attn
    shared = (hybrid_split(cfg, ssm)[0] if cfg.shared_attn_period else 0)
    prods = (2 if cfg.activation in GATED else 1) * ffn
    return {"rmsnorm": (2 * attn + 2 * mla + ssm + 2 * shared + 1) * steps,
            **gated_launches(ssm * steps, split),
            "masked_matmul": prods * steps,
            "flash_attention": attn - mla + shared, "ssd_scan": ssm,
            **dict.fromkeys(masked_matmul.route_launches, 0),
            "masked_matmul_bf16_tiles": prods,
            "masked_matmul_bf16_gemv": prods * decode}


def request_batches(cfg, requests):
    """[(label, batch)] drawn from SEED for each (label, B, S), S the
    sequence the stack sees (``repro_torch.data.requests``): a VLM
    config's vision prefix on a square grid of M-RoPE ids."""
    import numpy as np
    from repro_torch.data.requests import request_batch
    rng = np.random.default_rng(SEED)
    return [(label, request_batch(cfg, B, S, rng))
            for label, B, S in requests]


def kernel_path(cfg, params, masks, requests):
    """Each (label, batch) through the kernel path with the launch
    counters zeroed just before and read just after, held to
    ``expected_launches``. Returns ``serve_tokens``' result a request,
    with its launches, and the launch totals."""
    per_request = expected_launches(cfg)
    kern, totals = {}, dict.fromkeys(per_request, 0)
    for label, batch in requests:
        zero_launches()
        kern[label] = serve_tokens(cfg, params, masks, batch)
        counts = read_launches()
        if counts != per_request:
            raise AssertionError(f"{cfg.name} {label}: launches {counts}, "
                                 f"expected {per_request}")
        kern[label]["launches"] = counts
        for name in totals:
            totals[name] += counts[name]
    return kern, totals


def transformer_slice(cfg, params, masks, requests, to_fp32=None):
    """Phases 6, 8, 9 and 16-19: each request (label, B, S) through the
    kernel path (``kernel_path``); the same requests through the plain
    versions in bf16 and in fp32, teacher-forced with the kernel path's
    tokens; every logit row held to the tolerance. In an MoE stack a step
    whose own tokens the kernel path and the bf16 plain run routed to
    different experts in some layer (``flipped_steps``) is reported and
    not held: routing is discontinuous, and one bf16 rounding in a norm
    or an attention can move a token past the top-k boundary. The fp32
    run's parameters are ``to_fp32(params)`` (default: a float32 copy
    beside the bf16 tree), made after both bf16 runs. A bidirectional
    encoder's one logit row a request is every position's (B, S, V).
    Returns the per-request rows and the launch totals."""
    import torch
    from repro_torch.data.requests import batch_shape
    from repro_torch.device import exact_fp32
    from repro_torch.models import transformer as tr
    requests = request_batches(cfg, requests)
    with watch_moe() as kcalls:
        kern, totals = kernel_path(cfg, params, masks, requests)
    kroutes = routes_of(kcalls, len(requests))
    with watch_moe() as pcalls:
        plain = {label: serve_tokens(cfg, params, masks, batch, plain=True,
                                     forced=kern[label]["tokens"])
                 for label, batch in requests}
    proutes = routes_of(pcalls, len(requests))
    flipped = {}
    if cfg.moe is not None:
        for (label, batch), kr, pr in zip(requests, kroutes, proutes):
            flipped[label] = flipped_steps(cfg, batch_shape(cfg, batch),
                                           kr, pr)
    params32 = (to_fp32 or (lambda p: tr.cast_params(p, torch.float32)))(
        params)
    cfg32 = cfg.replace(dtype="float32")
    with exact_fp32():
        fp32 = {label: serve_tokens(cfg32, params32, masks, batch,
                                    plain=True, forced=kern[label]["tokens"])
                for label, batch in requests}
    del params32
    torch.cuda.empty_cache()

    rows = []
    for label, batch in requests:
        B, S = batch_shape(cfg, batch)
        shape = (B, cfg.padded_vocab) if cfg.causal else (
            B, S, cfg.padded_vocab)
        worst, gaps_k, gaps_p, gaps_kp = 0.0, [], [], []
        skip = flipped.get(label, [False] * len(kern[label]["logits"]))
        for g, p, f, flip in zip(kern[label]["logits"],
                                 plain[label]["logits"],
                                 fp32[label]["logits"], skip):
            if g.shape != shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{label}: bad logits {tuple(g.shape)}")
            gap_k = float((g - f).abs().max())
            gap_p = float((p - f).abs().max())
            # tolerance: the kernel path may be no farther from the fp32
            # run than twice the bf16 plain run is, plus one bf16 spacing
            # of the largest logit
            tol = 2 * gap_p + BF16_SPACING * float(f.abs().max())
            if not flip:
                worst = max(worst, gap_k / tol)
            gaps_k.append(gap_k)
            gaps_p.append(gap_p)
            gaps_kp.append(float((g - p).abs().max()))
        row = {"model": cfg.name, "num_layers": cfg.num_layers,
               "request": label, "batch": B, "prompt": S,
               "decode_steps": len(kern[label]["decode_ms"]),
               "prefill_ms": kern[label]["prefill_ms"],
               "prefill_tokens_per_s": B * S / kern[label]["prefill_ms"] * 1e3,
               "plain_prefill_ms": plain[label]["prefill_ms"]}
        if cfg.causal:
            med = statistics.median(kern[label]["decode_ms"])
            row.update(decode_ms=kern[label]["decode_ms"],
                       decode_ms_median=med,
                       decode_tokens_per_s=B / med * 1e3,
                       plain_decode_ms_median=statistics.median(
                           plain[label]["decode_ms"]))
        row.update({"launches": kern[label]["launches"],
                    "max_gap_kernel_vs_fp32": max(gaps_k),
                    "max_gap_bf16_plain_vs_fp32": max(gaps_p),
                    "max_gap_kernel_vs_bf16_plain": max(gaps_kp),
                    "max_gap_over_tol": worst,
                    "tokens": kern[label]["tokens"].tolist()})
        if label in flipped:
            row["flipped_steps"] = [i for i, f in enumerate(skip) if f]
        print("slice " + json.dumps(row), flush=True)
        if worst > 1.0:
            raise AssertionError(f"{cfg.name} {label}: kernel-path logits "
                                 f"off by {worst} of the tolerance")
        rows.append(row)
    return rows, totals


@contextlib.contextmanager
def watch_moe():
    """Record each MoE layer call of the stack made while the block runs:
    yields a list that gains, a call, (params, MoEConfig, input, expert
    mask, drop_frac, the tensor-parallel rank or 0, the sequence share or
    0: ``context_parallel``'s data rank). Storing references
    costs the timed run nothing; ``routes_of`` recomputes the routes
    afterwards (``moe.route`` is deterministic, and a split's router is
    whole on every rank). The stack looks ``moe_forward`` up in its module
    at each call, so the block wraps it there."""
    from repro_torch.models import transformer as tr
    calls, inner = [], tr.moe_forward

    def watched(params, moe, x, activation, *, expert_mask=None, tp=None):
        out, metrics = inner(params, moe, x, activation,
                             expert_mask=expert_mask, tp=tp)
        calls.append((params, moe, x, expert_mask, metrics.drop_frac,
                      0 if tp is None else tp.axis.rank,
                      0 if tp is None or tp.seq is None else tp.seq.rank))
        return out, metrics
    tr.moe_forward = watched
    try:
        yield calls
    finally:
        tr.moe_forward = inner


@contextlib.contextmanager
def routes_forced(routes):
    """While the block runs, each MoE layer call routes its tokens to the
    experts ``routes`` gives (``routes_of``'s list of one request: (experts
    (T, k), drop_frac) a call, in call order), each pick weighted by the
    call's own router scores renormalised over the picks, as the router
    does. Fails unless the calls take every route, in order, each at its
    shape. A stack without MoE layers has no routes and makes no call."""
    from repro_torch.models.layers import moe as moe_layer
    inner, queue = moe_layer._router, list(routes)

    def forced(params, moe, x2d, expert_mask):
        logits, scores = moe_layer._scores(params, moe, x2d, expert_mask)
        if not queue:
            raise AssertionError("an MoE call past the recorded routes")
        idx = queue.pop(0)[0]
        if tuple(idx.shape) != (x2d.shape[0], moe.top_k):
            raise AssertionError(f"recorded routes {tuple(idx.shape)} for "
                                 f"{x2d.shape[0]} tokens")
        probs = scores.gather(-1, idx)
        return (logits, probs / probs.sum(-1, keepdim=True).clamp_min(1e-9),
                idx)
    moe_layer._router = forced
    try:
        yield
    finally:
        moe_layer._router = inner
    if queue:
        raise AssertionError(f"{len(queue)} recorded routes not taken")


def routes_of(calls, n_requests: int):
    """The recorded MoE calls of ``n_requests`` requests served one after
    the other (each makes as many), as a list a request of (experts (T,
    k) each token was routed to, drop_frac) a call, in call order; of a
    split's shares, rank 0's. Empties ``calls``, releasing the layer
    inputs it held."""
    from repro_torch.models.layers.moe import route
    out = [(route(p, moe, x.reshape(-1, x.shape[-1]), mask)[1], float(drop))
           for p, moe, x, mask, drop, rank, _ in calls if rank == 0]
    calls.clear()
    per = len(out) // max(n_requests, 1)
    return [out[i * per:(i + 1) * per] for i in range(n_requests)]


def moe_layer_count(cfg) -> int:
    """The MoE layers of ``cfg``'s stack (each makes one recorded call a
    step)."""
    from repro_torch.models.transformer import layer_runs
    return sum(r.count for r in layer_runs(cfg) if r.kind == "moe")


def flipped_steps(cfg, shape, kroutes, proutes, steps: int = DECODE_STEPS):
    """For one request of ``shape`` (B, S) served by the kernel path and by
    the bf16 plain run (``routes_of`` of each), a prefill and ``steps``
    decode steps: a flag a step set where, in some MoE layer, the two
    routed one of that step's own tokens (the prefill's last token of each
    sequence, a decode step's B tokens) to different experts."""
    B, S = shape
    L = moe_layer_count(cfg)
    flags = []
    kr = [r for r, _ in kroutes]
    pr = [r for r, _ in proutes]
    for step in range(1 + steps):
        rows = ([b * S + S - 1 for b in range(B)] if step == 0
                else list(range(B)))
        flags.append(any(bool((kr[step * L + j][rows]
                               != pr[step * L + j][rows]).any())
                         for j in range(L)))
    return flags


def profile_transformer(cfg, params, masks, request=TRANSFORMER_REQUESTS[0]):
    """Phases 7, 10 and 16-19: device time of one prefill of ``request``
    (label, B, S), R1 unless given, and one decode step of the kernel
    path, against their unprofiled wall-clock."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    label, B, S = request
    batch = request_batches(cfg, [request])[0][1]
    prefill = make_prefill_step(cfg, max_len=S + DECODE_STEPS, masks=masks)
    state = {}

    def prefill_once():
        state["lg"], state["cache"] = prefill(params, batch)
        torch.cuda.synchronize()

    def decode_once():
        nxt = state["lg"].argmax(-1, keepdim=True)
        state["lg"], state["cache"] = decode(params, state["cache"], nxt)
        torch.cuda.synchronize()
    steps = [("prefill", prefill_once)]
    if cfg.causal:                 # an encoder has no decode step
        decode = make_decode_step(cfg, masks=masks)
        steps.append(("decode", decode_once))
    for step, fn in steps:
        prof = device_profile(fn)
        print("profile " + json.dumps({"model": cfg.name, "request": label,
                                       "step": step, **prof}), flush=True)
        if step == "prefill":
            check_traced(cfg, prof)


def check_traced(cfg, prof):
    """A prefill's trace holds every launch of the port's one-kernel
    wrappers (a flash attention, an FFN product on the wgmma tiles) that
    ``expected_launches`` counts: the device times above come from a
    whole trace."""
    want = expected_launches(cfg)
    for kind, name in (("flash_attention", "flash_attention"),
                       ("masked_matmul tiles", "masked_matmul_bf16_tiles")):
        got = prof["count_by_kind"].get(kind, 0)
        if got != want[name]:
            raise AssertionError(f"{cfg.name}: the prefill's trace holds "
                                 f"{got} {kind} kernels, {want[name]} "
                                 f"launched")


# ---------------------------------------------------------------------------
# phase 11: the socket deployment (AlexNet), both peers on the card
# ---------------------------------------------------------------------------
def free_port() -> int:
    """A TCP port on 127.0.0.1 that the OS assigns."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_bits(a, b) -> bool:
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def percentile(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs), q))


def zero_counts():
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    masked_matmul.launches = 0
    masked_matmul.route_launches = dict.fromkeys(
        masked_matmul.route_launches, 0)


def read_counts():
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    return masked_matmul.launches, {
        k: v for k, v in masked_matmul.route_launches.items() if v}


def local_reference(plan, images):
    """Phase 4's local backend on the card: each image's result and wall
    ms (host clock around ``infer``, which ends in a copy to the host)."""
    from repro_torch import serving
    sess = serving.connect(plan, backend="local")
    out, wall = [], []
    for img in images:
        t0 = time.perf_counter()
        out.append(sess.infer(img))
        wall.append(1e3 * (time.perf_counter() - t0))
    return out, wall


def expected_frame(plan, res):
    """What one request through the socket must give, from the local
    backend's result: at an interior split the same logits and
    ``tx_bytes``; at c=N the edge sends the logits themselves, so they
    come back through the plan's codec (as bits, the codec's roundtrip of
    the local logits) and the frame is their encoding."""
    from repro_torch.core.collab.protocol import decode_any, encode_feature
    if plan.split < len(plan.cfg.layers):
        return res["logits"], res["tx_bytes"]
    buf = encode_feature(res["logits"], codec=plan.codec)
    return decode_any(buf)[0], len(buf)


def socket_run(label, plan, images, local, local_wall, faults=None,
               expected_faults: int = 0, profile: bool = False):
    """Phase 11 for one plan: ``CloudServer(plan)`` on 127.0.0.1 and one
    ``connect(plan, "socket")`` session, both on the card in this process;
    the images sent one after another, each request's logits and
    ``tx_bytes`` held, bit for bit, to the local backend's, the
    ``masked_matmul`` launches (all from this thread: the cloud half runs
    no kernel of the port) counted from just before the first request to
    just after the last. With ``profile``, a ``profile`` line follows for
    one more request: both peers' device time against its wall-clock.
    Returns the ``socket`` row."""
    from repro_torch import serving
    with serving.CloudServer(plan, faults=faults) as server:
        with serving.connect(plan, backend="socket") as sess:
            zero_counts()
            got, wall = [], []
            for img in images:
                t0 = time.perf_counter()
                got.append(sess.infer(img))
                wall.append(1e3 * (time.perf_counter() - t0))
            launches, routes = read_counts()
            if profile:
                print("profile " + json.dumps({
                    "path": f"socket {label}", "split": plan.split,
                    **device_profile(lambda: sess.infer(images[0]))}),
                    flush=True)
    for i, (g, w) in enumerate(zip(got, local)):
        want, tx = expected_frame(plan, w)
        if not same_bits(g["logits"], want) or g["tx_bytes"] != tx:
            raise AssertionError(f"socket {label}: request {i} differs from "
                                 f"the local backend (tx {g['tx_bytes']} "
                                 f"against {tx})")
    want_routes = {k: v * len(images) for k, v in edge_routes(plan).items()}
    if launches != edge_gemm_count(plan) * len(images) or \
            routes != want_routes:
        raise AssertionError(f"socket {label}: masked_matmul {launches} "
                             f"launches {routes}, expected {want_routes}")
    n_faults = sum(g["fault"]["faults"] for g in got)
    n_retries = sum(g["fault"]["retries"] for g in got)
    if n_faults != expected_faults or n_retries != expected_faults or \
            any(g["fault"]["fallback"] for g in got):
        raise AssertionError(f"socket {label}: fault records "
                             f"{[g['fault'] for g in got]}")
    row = {"plan": label, "split": plan.split, "requests": len(images),
           "bit_identical_to_local": True, "tx_bytes": got[0]["tx_bytes"],
           "launches": launches, "routes": routes,
           "faults": n_faults, "retries": n_retries,
           "fault_records": [g["fault"] for g in got],
           "server_fault_stats": dict(server.fault_stats),
           "wall_ms": wall,
           "wall_ms_median": statistics.median(wall[1:]),
           "wall_ms_p90": percentile(wall[1:], 90),
           "t_edge_ms_median": 1e3 * statistics.median(
               g["t_edge"] for g in got[1:]),
           "t_upstream_ms_median": 1e3 * statistics.median(
               g["t_upstream"] for g in got[1:]),
           "local_wall_ms_median": statistics.median(local_wall[1:]),
           "local_wall_ms_p90": percentile(local_wall[1:], 90)}
    print("socket " + json.dumps(row), flush=True)
    return row


def socket_batched(plan, images_by_client, local_by_client):
    """Phase 11, batching plan: ``CloudServer(plan)``, one
    ``SocketSession`` per client opened first (its deployment built, its
    HELLO done), then one client sending its images alone (req/s of one
    client) and all of them at once, each from its own thread (req/s of
    the fleet of clients); each row's logits held, bit for bit, to the
    local backend's; the server's lane accounting must show batches of
    more than one row."""
    import threading
    from repro_torch import serving
    got, wall, errors = {}, {}, []

    def client(c, sess, images):
        try:
            got[c], wall[c] = [], []
            for img in images:
                t0 = time.perf_counter()
                got[c].append(sess.infer(img))
                wall[c].append(1e3 * (time.perf_counter() - t0))
        except Exception as e:                           # noqa: BLE001
            errors.append(e)
    with serving.CloudServer(plan) as server:
        sessions = {c: serving.connect(plan, backend="socket")
                    for c in images_by_client}
        first = next(iter(images_by_client))
        t0 = time.perf_counter()
        client(first, sessions[first], images_by_client[first])
        one_s = time.perf_counter() - t0
        solo, solo_wall = got.pop(first), wall.pop(first)
        threads = [threading.Thread(target=client,
                                    args=(c, sessions[c], ims))
                   for c, ims in images_by_client.items()]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        all_s = time.perf_counter() - t0
        for sess in sessions.values():
            sess.close()
    if errors:
        raise errors[0]
    for c, results in [*got.items(), ("alone", solo)]:
        local = local_by_client[first if c == "alone" else c]
        for i, (res, want) in enumerate(zip(results, local)):
            logits, tx = expected_frame(plan, want)
            if not same_bits(res["logits"], logits) or res["tx_bytes"] != tx:
                raise AssertionError(f"socket batched: client {c} request "
                                     f"{i} differs from sequential")
    sizes = [b for lane in server.batch_stats.values()
             for b in lane["batch_sizes"]]
    n = sum(len(ims) for ims in images_by_client.values())
    if max(sizes, default=0) < 2:
        raise AssertionError(f"socket batched: no batch of more than one "
                             f"row ({server.batch_stats})")
    together = [w for ws in wall.values() for w in ws[1:]]
    row = {"plan": "batched", "split": plan.split,
           "max_batch": plan.batching.max_batch,
           "max_wait_ms": plan.batching.max_wait_ms,
           "clients": len(images_by_client), "requests": n,
           "bit_identical_to_sequential": True,
           "req_per_s": n / all_s,
           "one_client_req_per_s": len(solo) / one_s,
           "wall_ms_median": statistics.median(together),
           "wall_ms_p90": percentile(together, 90),
           "one_client_wall_ms_median": statistics.median(solo_wall[1:]),
           "one_client_wall_ms_p90": percentile(solo_wall[1:], 90),
           "rows_served": sum(l["rows"] for l in server.batch_stats.values()),
           "batches": sum(l["batches"] for l in server.batch_stats.values()),
           "batch_sizes": sizes}
    print("socket " + json.dumps(row), flush=True)
    return row


def socket_phase(plans, images):
    """Phase 11: the socket deployment of the int8 compacted AlexNet. c=19
    (every layer on the edge: the logits cross the wire) and c=13 (the
    convs on the edge, the dense layers in the cloud), plain; c=13 with a
    ``batching`` section (4 clients at once); c=13 with a ``faults``
    section and a server that drops one response and corrupts another,
    each recovered by replay. Returns the routes of the counted runs."""
    import numpy as np
    from repro_torch.core.collab.channel import FaultInjector
    from repro_torch.core.partition.profiles import FaultEvent, FaultSchedule
    from repro_torch.serving import BatchingPolicy, FaultPolicy

    def on_socket(plan, **sections):
        # loopback without the link shaper: what is measured is the TCP
        # hop, the framing and the threads, not a modelled Wi-Fi link
        return dataclasses.replace(plan, port=free_port(), shape_link=False,
                                   **sections)
    routes = collections.Counter()
    for label in ("greedy", "c13"):
        plan = on_socket(plans[label])
        local, local_wall = local_reference(plan, images)
        routes.update(socket_run(label, plan, images, local, local_wall,
                                 profile=True)["routes"])
    c13 = plans["c13"]
    local, local_wall = local_reference(c13, images)
    faults = FaultInjector(FaultSchedule("drop_and_corrupt", (
        FaultEvent(2, "drop"), FaultEvent(5, "corrupt"))))
    routes.update(socket_run(
        "faults", on_socket(c13, faults=FaultPolicy(
            max_retries=3, backoff_base_s=0.001, request_deadline_s=4.0)),
        images, local, local_wall, faults=faults,
        expected_faults=2)["routes"])
    rng = np.random.default_rng(SEED + 11)
    by_client = {c: [rng.standard_normal((1, 224, 224, 3), dtype=np.float32)
                     for _ in range(REQUESTS)] for c in range(4)}
    batched = on_socket(c13, batching=BatchingPolicy(max_batch=4,
                                                     max_wait_ms=2.0))
    local_by_client = {c: local_reference(batched, ims)[0]
                       for c, ims in by_client.items()}
    socket_batched(batched, by_client, local_by_client)
    return routes

# ---------------------------------------------------------------------------
# phase 12: the paper's pipeline at full AlexNet width, on the card
# ---------------------------------------------------------------------------
#: one train step on the card against the same step in float64 on the
#: CPU: the loss within this relative gap, each parameter's update within
#: this share of its norm. Measured on an H100 80GB HBM3 (700 W): loss
#: 7e-8, updates at most 1.8e-4 of their norm (cuDNN's filter gradients of
#: the 11x11 and 5x5 convs), and the CPU's own float32 step 7.7e-4 from
#: float64 (oneDNN's); the same step on the card with TF32 on is reported
#: beside them (``tf32_*``), to show what the check tells apart
STEP_LOSS_RTOL = 1e-6
STEP_UPDATE_RTOL = 5e-4


def direct_step(cfg, params, batch, lr: float, device: str, dtype):
    """The loss and each leaf's update of the first SGD step (momentum
    starts at zero, so the update is ``-lr * grad``) by autograd on
    ``cnn_apply`` in ``dtype`` on ``device``, under the caller's TF32
    switches; returned on the CPU in float64."""
    import numpy as np
    import torch
    from repro_torch.core.pipeline import _xent
    from repro_torch.models.cnn import cnn_apply
    from repro_torch.optim import value_and_grad
    x = torch.from_numpy(batch["image"]).to(device, dtype)
    y = torch.from_numpy(batch["label"].astype(np.int64)).to(device)
    loss, grads = value_and_grad(
        lambda p: _xent(cnn_apply(p, cfg, x), y),
        {k: {n: t.to(device, dtype) for n, t in v.items()}
         for k, v in params.items()})
    return float(loss), {(k, n): -lr * g.double().cpu()
                         for k, v in grads.items() for n, g in v.items()}


def step_gaps(loss, updates, loss64, want):
    """(loss gap relative to float64, the largest update gap as a share
    of the float64 update's norm)."""
    worst = 0.0
    for kn, w in want.items():
        worst = max(worst, float((updates[kn] - w).norm())
                    / max(float(w.norm()), 1e-30))
    return abs(loss - loss64) / abs(loss64), worst


def train_step_check(cfg, data):
    """One SGD step (momentum 0.9, StepLR) of ``make_train_step`` from the
    same parameters and batch on the card (TF32 off) and on the CPU in
    float32, each update ``p1 - p0`` and loss held to the same step in
    float64 on the CPU (the card's within the tolerances above; the CPU's,
    and the card's with TF32 on, reported beside it). Then the card's step
    timed: host clock around each step, which ends when its loss reaches
    the host. Returns the row."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline
    from repro_torch.models.cnn import init_cnn_params
    from repro_torch.optim import make_optimizer, step_lr
    steps_per_epoch = max(len(data.train_ids) // 32, 1)
    schedule = step_lr(0.01, 0.1, 20, steps_per_epoch)
    opt = make_optimizer("sgd", schedule, momentum=0.9)
    batch = next(data.iter_train(32, epochs=1, seed=100))
    p0 = init_cnn_params(SEED, cfg)
    lr = float(schedule(0))
    loss64, want = direct_step(cfg, p0, batch, lr, "cpu", torch.float64)
    device = "cuda"
    gaps, out = {}, {}
    for dev in (device, "cpu"):
        p = pipeline.params_to(p0, torch.device(dev))
        step = pipeline.make_train_step(cfg, opt, device=dev)
        out[dev] = (step, *step(p, opt.init(p), batch))
        _, p1, _, loss = out[dev]
        updates = {(k, n): (p1[k][n].cpu() - p0[k][n]).double()
                   for k, n in want}
        gaps[dev] = step_gaps(float(loss), updates, loss64, want)
    switches = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gaps["tf32"] = step_gaps(*direct_step(
            cfg, p0, batch, lr, device, torch.float32), loss64, want)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = switches
    loss_gap, worst = gaps[device]
    if not (np.isfinite(loss_gap) and loss_gap <= STEP_LOSS_RTOL
            and worst <= STEP_UPDATE_RTOL):
        raise AssertionError(f"pipeline: a train step on {device} differs "
                             f"from float64: loss gap {loss_gap}, update "
                             f"gap {worst} of its norm")
    step, p, s, loss_dev = out[device]
    ms = []
    for _ in range(8):
        t0 = time.perf_counter()
        p, s, loss = step(p, s, batch)
        float(loss)
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"loss_card": float(loss_dev), "loss_f64": loss64,
            "loss_rel_gap": loss_gap, "loss_rtol": STEP_LOSS_RTOL,
            "update_rel_gap": worst, "update_rtol": STEP_UPDATE_RTOL,
            "cpu_f32_loss_rel_gap": gaps["cpu"][0],
            "cpu_f32_update_rel_gap": gaps["cpu"][1],
            "tf32_loss_rel_gap": gaps["tf32"][0],
            "tf32_update_rel_gap": gaps["tf32"][1],
            "train_step_ms": ms,
            "train_step_ms_median": statistics.median(ms[1:])}


def search_timings(cfg, data):
    """One stage-2 reward evaluation on the card (masks from the ratios,
    the masked forward over the evaluation subset, top-1 on the host; each
    ratio vector new, so no cache hit) and the agent alone (12 episodes, 4
    of warm-up, against a reward that does no device work): ms each, and
    the ms of an episode that updates the agent (each episode from the
    5th on: 7 transitions an episode fill the batch of 32 after 5), timed
    between consecutive rewards. From these, the search's seconds per 100
    episodes (an updating episode and a reward each), the unit a longer
    search costs."""
    import numpy as np
    from repro_torch.core import pipeline
    from repro_torch.core.pruning.amc_env import PruningEnv, cnn_layer_descs
    from repro_torch.core.pruning.policy import search_pruning_policy
    from repro_torch.models.cnn import init_cnn_params, prunable_layers
    evaluate = pipeline.reward_evaluator(init_cnn_params(SEED, cfg), cfg,
                                         data, device="cuda")
    rng = np.random.default_rng(SEED + 12)
    n_layers = len(prunable_layers(cfg))
    reward_ms = []
    for _ in range(6):
        actions = rng.uniform(0.1, 1.0, n_layers).tolist()
        t0 = time.perf_counter()
        evaluate(actions)
        reward_ms.append(1e3 * (time.perf_counter() - t0))
    stamps = []

    def reward(actions):
        stamps.append(time.perf_counter())
        return float(np.mean(actions))
    env = PruningEnv(cnn_layer_descs(cfg), reward)
    t0 = time.perf_counter()
    search_pruning_policy(env, episodes=12, warmup=4, seed=SEED,
                          device="cuda")
    agent_s = time.perf_counter() - t0
    updating = [1e3 * (b - a) for a, b in zip(stamps[4:], stamps[5:])]
    row = {"reward_eval_ms": reward_ms,
           "reward_eval_ms_median": statistics.median(reward_ms[1:]),
           "agent_ms_per_episode": 1e3 * agent_s / 12,
           "agent_ms_per_updating_episode": updating,
           "agent_ms_per_updating_episode_median":
               statistics.median(updating)}
    row["search_s_per_100_episodes"] = 0.1 * (
        row["agent_ms_per_updating_episode_median"]
        + row["reward_eval_ms_median"])
    return row


def check_pipeline_result(res, budget: float) -> None:
    """What the pipeline must give: finite losses (from its log), FLOPs
    kept within the budget (AMC's clipping keeps the budget reachable
    whenever it is above the 0.1 action floor), every ratio in the action
    range, N + 1 rows in each split table with the argmin chosen, and a
    plan whose digest survives ``save``/``load``."""
    import tempfile
    from repro_torch import serving
    if not res.search.best_flops_kept <= budget + 1e-9:
        raise AssertionError(f"pipeline: FLOPs kept "
                             f"{res.search.best_flops_kept} over {budget}")
    if not all(0.05 <= r <= 1.0 for r in res.ratios.values()):
        raise AssertionError(f"pipeline: ratios {res.ratios}")
    n = len(res.cfg.layers)
    for dec in (res.split, res.deploy_split):
        best = min(dec.table, key=lambda r: r["T"])["split"]
        if len(dec.table) != n + 1 or dec.split_point != best:
            raise AssertionError(f"pipeline: split table of "
                                 f"{len(dec.table)} rows, decision "
                                 f"{dec.split_point}, argmin {best}")
    with tempfile.TemporaryDirectory() as tmp:
        loaded = serving.DeploymentPlan.load(res.plan.save(tmp))
    if loaded.digest != res.plan.digest:
        raise AssertionError("pipeline: plan digest changed through "
                             "save/load")


def pipeline_phase(images):
    """Phase 12: ``run_paper_pipeline`` at full ``alexnet_config(38)``
    width on the card with the paper's SGD (momentum 0.9) and StepLR: 2
    training epochs of 7 steps at batch 32 over
    ``PlantVillageSynthetic(n_per_class=8, hw=224)``, 12 DDPG episodes (4
    of warm-up), 1 fine-tuning epoch, FLOPs budget 0.5; then its plan
    with an int8 ``quant`` section served through ``connect(plan,
    "local")`` as phase 4 serves its plans. Returns the serving row."""
    import math
    import re
    from repro_torch import serving
    from repro_torch.core import pipeline
    from repro_torch.data.synthetic import PlantVillageSynthetic
    from repro_torch.models.cnn import alexnet_config
    cfg, hw = alexnet_config(38), 224
    t0 = time.perf_counter()
    data = PlantVillageSynthetic(n_per_class=8, hw=hw, seed=SEED)
    data._batch(data.train_ids)          # every image made once, up front
    data._batch(data.test_ids)
    data_s = time.perf_counter() - t0
    row = {"cfg": cfg.name, "hw": hw, "images": data.n_per_class * 38,
           "data_s": data_s}
    row.update(train_step_check(cfg, data))
    row.update(search_timings(cfg, data))
    budget = 0.5
    lines = []
    t0 = time.perf_counter()
    res = pipeline.run_paper_pipeline(
        cfg, data, train_epochs=2, finetune_epochs=1, episodes=12, warmup=4,
        flops_budget=budget, seed=SEED, optimizer_name="sgd", lr=0.01,
        deploy_codec="int8", device="cuda",
        log=lambda m: lines.append((time.perf_counter() - t0, m)))
    row["pipeline_s"] = time.perf_counter() - t0
    for _, m in lines:
        print(f"pipeline log {m}", flush=True)
    losses = [float(x) for _, m in lines
              for x in re.findall(r"^epoch \d+: loss (\S+)$", m)]
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"pipeline: epoch losses {losses}")
    marks = [(t, m[:5]) for t, m in lines if m.startswith("[")]
    ends = [t for t, _ in marks[1:]] + [row["pipeline_s"]]
    check_pipeline_result(res, budget)
    row.update({
        "epoch_losses": losses,
        "stage_s": {m: e - t for (t, m), e in zip(marks, ends)},
        "acc_original": res.acc_original, "acc_pruned": res.acc_pruned,
        "acc_finetuned": res.acc_finetuned,
        "ratios": {str(k): v for k, v in res.ratios.items()},
        "flops_kept": res.search.best_flops_kept, "flops_budget": budget,
        "best_reward": res.search.best_reward,
        "split": res.split.split_point,
        "deploy_split": res.deploy_split.split_point,
        "digest": res.plan.digest})
    print("pipeline " + json.dumps(row, default=float), flush=True)
    plan = serving.DeploymentPlan.from_pipeline(
        res, quant=serving.QuantPolicy(weight_bits=8))
    return serve_path("pipeline", plan, images, edge_gemm_count(plan))


# ---------------------------------------------------------------------------
# phase 13: the streaming backend (AlexNet), on the card
# ---------------------------------------------------------------------------
def stream_frames(report):
    """The stream's frames as lists of request ids: the edge stage fuses
    consecutive requests, and each result records its frame's size."""
    out, i = [], 0
    while i < len(report.results):
        n = report.results[i]["frame_n"]
        if any(r["frame_n"] != n for r in report.results[i:i + n]):
            raise AssertionError(f"streaming: a frame of {n} at request "
                                 f"{i} holds requests of other frames")
        out.append(list(range(i, i + n)))
        i += n
    return out


def stream_expected(halves, call, codec, images, frames, protocol=None):
    """Each request's logits and ``tx_bytes`` as batch-1 split halves give
    them over the stream's frames: every request's edge output, one frame
    per fused group through ``codec`` (one int8 scale a frame, as the
    reference's edge stage encodes its fused rows), each decoded row
    through the cloud half. ``halves`` is ``(edge, cloud, keep)`` of a
    split-function bank and ``call(fn, x)`` runs one half to a numpy
    array; ``protocol`` the wire module (the port's unless given)."""
    import numpy as np
    if protocol is None:
        from repro_torch.core.collab import protocol
    edge, cloud, keep = halves
    out = {}
    for ids in frames:
        feats = [call(edge, images[i]) if edge else images[i] for i in ids]
        if cloud is None:
            out.update({i: (f, 0) for i, f in zip(ids, feats)})
            continue
        buf = protocol.encode_feature(np.concatenate(feats), codec=codec,
                                      keep=keep)
        dec = protocol.decode_any(buf)[0]
        for j, i in enumerate(ids):
            out[i] = (call(cloud, dec[j:j + 1]), int(len(buf) / len(ids)))
    return [out[i] for i in range(len(images))]


def check_stream(label, mb, sess, plan, images, got, local):
    """Every row the session's last stream gave (``got``) and its
    ``tx_bytes`` equal, bit for bit, to the local backend's halves over the
    frames it fused, and at ``microbatch`` 1 to the local backend's own
    results (``local``, one a phase-4 image; ``images`` are those images,
    taken cyclically). Returns the frames."""
    bank = sess._runner._bank
    frames = stream_frames(sess.last_report)
    expected = stream_expected(bank.get(plan.split), bank.call, plan.codec,
                               images, frames)
    if len(got) != len(images):
        raise AssertionError(f"streaming {label}: {len(got)} results for "
                             f"{len(images)} requests")
    for i, (g, (logits, tx)) in enumerate(zip(got, expected)):
        w = local[i % len(local)]
        ok = same_bits(g["logits"], logits) and g["tx_bytes"] == tx
        if mb == 1:
            ok = ok and same_bits(g["logits"], w["logits"]) and \
                g["tx_bytes"] == w["tx_bytes"]
        if not ok:
            raise AssertionError(
                f"streaming {label} microbatch {mb}: request {i} differs "
                f"(tx {g['tx_bytes']}, local {w['tx_bytes']}, frames "
                f"{[len(f) for f in frames]})")
    return frames


def local_rate(sess, images) -> float:
    """req/s of the local backend over ``images`` served one after
    another: the requests over the host clock around the whole loop."""
    t0 = time.perf_counter()
    for img in images:
        sess.infer(img)
    return len(images) / (time.perf_counter() - t0)


def streaming_phase(plans, images):
    """Phase 13: phase 4's int8 compacted plans at c=13 (the dense layers
    in the cloud) and c=19 through ``connect(plan, "streaming",
    realtime_channel=False)`` with ``microbatch`` 1 and 4. A stream of the
    ``REQUESTS`` images first: every logit row and ``tx_bytes`` bit-equal
    to the local backend's halves over the frames the stream formed (and at
    ``microbatch`` 1 to the local backend's results), ``masked_matmul``
    launches (the edge stage is the one thread that launches) = edge GEMMs
    x requests on their routes. Then the timing, in ``STREAM_ROUNDS``
    rounds: the local backend over ``STREAM_REQUESTS`` requests (the
    images taken cyclically), then a stream of the same requests at each
    ``microbatch``, each held to the same bits; req/s of each is the
    requests over the host clock around the whole run. Returns the
    routes."""
    from repro_torch import serving
    routes = collections.Counter()
    timed = [images[i % len(images)] for i in range(STREAM_REQUESTS)]
    for label in ("c13", "greedy"):
        plan = plans[label]
        local, _ = local_reference(plan, images)
        sessions, rows = {}, {}
        for mb in (1, 4):
            sess = serving.connect(plan, backend="streaming",
                                   realtime_channel=False, microbatch=mb)
            zero_counts()
            got = sess.infer_many(images)
            launches, counted = read_counts()
            frames = check_stream(label, mb, sess, plan, images, got,
                                  local)
            want = {k: v * len(images) for k, v in edge_routes(plan).items()}
            if launches != edge_gemm_count(plan) * len(images) or \
                    counted != want:
                raise AssertionError(
                    f"streaming {label}: masked_matmul {launches} launches "
                    f"{counted}, expected {want}")
            routes.update(counted)
            sessions[mb] = sess
            rows[mb] = {"plan": label, "split": plan.split, "microbatch": mb,
                        "requests": len(images),
                        "frames": [len(f) for f in frames],
                        "bit_identical": True, "tx_bytes": got[0]["tx_bytes"],
                        "launches": launches, "routes": counted,
                        "timed_requests": len(timed), "req_per_s": [],
                        "local_req_per_s": [], "frame_sizes": [],
                        "occupancy": [], "busy_ms": []}
        lsess = serving.connect(plan, backend="local")
        for _ in range(STREAM_ROUNDS):
            rate = local_rate(lsess, timed)
            for mb, sess in sessions.items():
                got = sess.infer_many(timed)
                frames = check_stream(label, mb, sess, plan, timed, got,
                                      local)
                rep, row = sess.last_report, rows[mb]
                row["local_req_per_s"].append(rate)
                row["req_per_s"].append(rep.throughput_rps)
                row["frame_sizes"].append(dict(sorted(collections.Counter(
                    len(f) for f in frames).items())))
                row["occupancy"].append(rep.occupancy)
                row["busy_ms"].append({k: 1e3 * st.busy_s
                                       for k, st in rep.stages.items()})
        for row in rows.values():
            row["stream_over_local"] = [
                s / l for s, l in zip(row["req_per_s"],
                                      row["local_req_per_s"])]
            print("streaming " + json.dumps(row), flush=True)
    return routes


# ---------------------------------------------------------------------------
# phase 14: calibration, energy and the adaptive split controller (AlexNet)
# ---------------------------------------------------------------------------
#: timed calls a layer in the calibration (after one untimed call)
CALIBRATION_REPEATS = 10
#: requests the adaptive local session serves
ADAPTIVE_REQUESTS = 24
#: the adaptive phase's link: the paper's 50 Mbps Wi-Fi (4 ms RTT) for the
#: first 150 ms of the trace's virtual clock, then 2 Mbps
ADAPTIVE_TRACE = ((0.15, 50.0), (float("inf"), 2.0))


def adaptive_plans(plans):
    """Phase 4's int8 compacted c=13 plan re-cut for phase 14: a
    phone-class edge (``PHONE_EDGE``, the paper's server, 50 Mbps Wi-Fi)
    where the greedy split is c=3 on a healthy link and c=19 on a weak
    one; (energy plan, adaptive + energy plan). The energy section prices
    a phone's draw (``PHONE_ENERGY``) with a 2 J battery that drains."""
    from repro_torch.core.partition.profiles import (PAPER_SERVER,
                                                     PAPER_WIFI, PHONE_EDGE,
                                                     TwoTierProfile)
    from repro_torch.core.partition.energy_model import (PHONE_ENERGY,
                                                         EnergyPolicy)
    from repro_torch.serving import AdaptivePolicy
    n = len(plans["c13"].cfg.layers)
    energy = dataclasses.replace(
        plans["c13"], split=3,
        profile=TwoTierProfile(PHONE_EDGE, PAPER_SERVER, PAPER_WIFI),
        energy=EnergyPolicy(profile=PHONE_ENERGY, energy_weight_s_per_j=0.1,
                            battery_j=2.0))
    adaptive = dataclasses.replace(energy, adaptive=AdaptivePolicy(
        candidates=(0, 3, 6, 13, n), ewma_alpha=0.5, min_samples=2,
        hysteresis=0.1, dwell=2))
    return energy, adaptive


def ran_at(switches, initial: int, n: int):
    """The split each of ``n`` requests ran at (a switch decided after
    request k applies from request k + 1)."""
    out, split, pending = [], initial, list(switches)
    for i in range(n):
        while pending and pending[0].request_index <= i:
            split = pending.pop(0).new_split
        out.append(split)
    return out


def calibration(plans, images, alex_rows):
    """Phase 14.1-2: ``calibrate_quant_edge`` over the c=19 plan's int8
    bank and ``measure_cnn_layer_times`` over its float32 layers on the
    card, the sweeps they feed (PAPER_PROFILE: measured pick beside the
    analytic one) and the energy-aware picks and Pareto fronts of a
    phone-class edge over the calibrated costs. Returns the routes of the
    calibration's launches."""
    import torch
    from repro_torch.core.collab.quant import (calibrate_quant_edge,
                                               quantize_params)
    from repro_torch.core.collab.runtime import deploy_submodels
    from repro_torch.core.partition.latency_model import (
        cnn_input_bytes, measure_cnn_layer_times, quantized_cnn_layer_costs,
        wire_tx_scale)
    from repro_torch.core.partition.profiles import (PAPER_PROFILE,
                                                     PAPER_SERVER,
                                                     PAPER_WIFI, PHONE_EDGE,
                                                     LinkProfile,
                                                     TwoTierProfile)
    from repro_torch.core.partition.splitter import (energy_aware_split,
                                                     greedy_split,
                                                     pareto_front,
                                                     sweep_splits)
    from repro_torch.core.partition.energy_model import (PHONE_ENERGY,
                                                         EnergyPolicy)
    plan = plans["cN"]
    n = len(plan.cfg.layers)
    dparams, dcfg, dmasks = deploy_submodels(plan.params, plan.cfg,
                                             plan.masks, plan.compact)
    bank = quantize_params(dparams, dcfg, plan.quant)
    want = {k: v * (1 + CALIBRATION_REPEATS)
            for k, v in edge_routes(plan).items()}
    # the two calibrations in turns (int8, fp32, fp32, int8), so that the
    # card's clocks after an idle spell weigh on neither alone
    q8_rounds, fp32_rounds, routes = [], [], collections.Counter()
    for kind in ("int8", "fp32", "fp32", "int8"):
        if kind == "fp32":
            fp32_rounds.append(measure_cnn_layer_times(
                dparams, dcfg, images[0], masks=dmasks,
                repeats=CALIBRATION_REPEATS))
            continue
        zero_counts()
        q8_rounds.append(calibrate_quant_edge(
            bank, dcfg, images[0], masks=dmasks,
            repeats=CALIBRATION_REPEATS))
        launches, counted = read_counts()
        if counted != want or launches != \
                edge_gemm_count(plan) * (1 + CALIBRATION_REPEATS):
            raise AssertionError(f"calibrate: masked_matmul {launches} "
                                 f"launches {counted}, expected {want}")
        routes.update(counted)
    for name, ts in ([("int8 kernel", c.layer_s) for c in q8_rounds]
                     + [("fp32", t) for t in fp32_rounds]):
        if len(ts) != n or not all(0 < t < float("inf") for t in ts):
            raise AssertionError(f"calibrate: {name} layer times {ts}")
    torch.cuda.synchronize()
    cal, fp32_s = q8_rounds[-1], fp32_rounds[-1]
    costs = quantized_cnn_layer_costs(plan.cfg, plan.masks, 8)
    kw = dict(tx_scale=lambda c: wire_tx_scale(
        plan.cfg, plan.masks, c, codec=plan.codec, compact=True))
    inp = cnn_input_bytes(plan.cfg)
    measured = sweep_splits(costs, PAPER_PROFILE, inp,
                            measured_device_s=cal.layer_s, **kw)
    analytic = greedy_split(costs, PAPER_PROFILE, inp, **kw)
    pick = greedy_split(costs, PAPER_PROFILE, inp,
                        measured_device_s=cal.layer_s, **kw)
    if len(measured) != n + 1 or pick.latency["T"] != \
            min(r["T"] for r in measured):
        raise AssertionError("calibrate: the measured sweep's pick is not "
                             "its argmin")
    row = {"plan": "cN", "repeats": CALIBRATION_REPEATS,
           "timer": "cuda events around each call, device idle before it",
           "rounds": "int8, fp32, fp32, int8; layer_ms from the last of each",
           "launches": sum(routes.values()), "routes": dict(routes),
           "layer_ms_int8_kernel": [1e3 * t for t in cal.layer_s],
           "layer_ms_fp32": [1e3 * t for t in fp32_s],
           "total_ms_int8_kernel": 1e3 * cal.total_s(),
           "total_ms_fp32": 1e3 * sum(fp32_s),
           "total_ms_int8_kernel_rounds": [1e3 * c.total_s()
                                           for c in q8_rounds],
           "total_ms_fp32_rounds": [1e3 * sum(t) for t in fp32_rounds],
           "phase4_edge_ms_median": alex_rows["cN"]["edge_ms_median"],
           "phase4_edge_ms_first": alex_rows["cN"]["edge_ms_first"],
           "measured_pick": pick.split_point,
           "analytic_pick": analytic.split_point,
           "measured_T_ms": [1e3 * r["T"] for r in measured],
           "analytic_T_ms": [1e3 * r["T"] for r in analytic.table]}
    print("calibrate " + json.dumps(row), flush=True)
    # the energy objective of a phone-class edge, on the card's calibrated
    # layer times and on the phone's analytic ones, at the paper's 50 Mbps
    # and at 10 Mbps (where latency and joules pull apart)
    for mbps, source, extra in (
            (m, src, ext) for m in (50.0, 10.0)
            for src, ext in (("calibrated",
                              {"measured_device_s": cal.layer_s}),
                             ("analytic", {}))):
        phone = TwoTierProfile(PHONE_EDGE, PAPER_SERVER, LinkProfile(
            f"{mbps:g} Mbps", mbps * 1e6 / 8, PAPER_WIFI.rtt_s))
        greedy = greedy_split(costs, phone, inp, **kw, **extra).split_point
        picks = {}
        for w in (0.0, 0.1, 1.0, 10.0):
            dec = energy_aware_split(
                costs, phone, inp,
                EnergyPolicy(profile=PHONE_ENERGY, energy_weight_s_per_j=w),
                **kw, **extra)
            picks[str(w)] = dec.split_point
        if picks["0.0"] != greedy:
            raise AssertionError(f"energy {source}: weight 0 picks "
                                 f"{picks['0.0']}, greedy {greedy}")
        front = pareto_front(dec.table)
        ts, es = [r["T"] for r in front], [r["E_edge"] for r in front]
        if not front or ts != sorted(ts) or \
                not all(a > b for a, b in zip(es, es[1:])):
            raise AssertionError(f"energy {source}: front {front}")
        print("energy " + json.dumps({
            "costs": source, "link_mbps": mbps,
            "profile": "PHONE_EDGE + PHONE_ENERGY",
            "greedy": greedy, "picks_by_weight_s_per_j": picks,
            "front": [{"split": r["split"], "ms": 1e3 * r["T"],
                       "mJ": 1e3 * r["E_edge"]} for r in front]}),
            flush=True)
    return dict(routes), cal


def adaptive_local(plan, images):
    """Phase 14.3: ``connect(plan, "local", trace=...)`` on the card over
    ``ADAPTIVE_REQUESTS`` requests, and the same on ``device="cpu"``. The
    switch lists must agree (``simulate_compute`` makes every decision
    input device-independent) and hold a switch; each request bit-equal
    to a fixed-split session at the split it ran at, its ``e_edge_j`` the
    energy profile's price of its timing, the launches Σ edge GEMMs of
    the splits the requests ran at (the candidates' warm-up counted
    apart). The control loop's host cost: each request's wall ms taken in
    turns with the same request through a session of the same plan fixed
    at that split (same trace and energy section, no controller), and
    the controller's ``step`` timed inside the run. Returns (row,
    routes)."""
    from repro_torch import serving
    from repro_torch.core.partition.latency_model import (
        cnn_input_bytes, compacted_cnn_layer_costs, split_latency,
        wire_tx_scale)
    from repro_torch.core.partition.profiles import LinkTrace
    trace = lambda: LinkTrace.from_mbps("degrade", ADAPTIVE_TRACE,  # noqa
                                        rtt_ms=4.0)
    reqs = [images[i % len(images)] for i in range(ADAPTIVE_REQUESTS)]
    zero_counts()
    sess = serving.connect(plan, backend="local", trace=trace())
    warm, warm_routes = read_counts()
    want_warm = collections.Counter()
    for c in plan.adaptive.candidates:
        want_warm.update(edge_routes(plan, c))
    if warm_routes != dict(want_warm):
        raise AssertionError(f"adaptive: warm-up routes {warm_routes}, "
                             f"expected {dict(want_warm)}")
    ctl = sess._controller
    step, step_us = ctl.step, []

    def timed_step(*args):               # the control loop's host cost
        t0 = time.perf_counter()
        out = step(*args)
        step_us.append(1e6 * (time.perf_counter() - t0))
        return out
    ctl.step = timed_step
    got, wall, ran, fixed_got = [], [], [], []
    fixed, fixed_wall = {}, []
    launches, routes = 0, collections.Counter()
    for img in reqs:
        c = sess.split
        if c not in fixed:
            fixed[c] = serving.connect(dataclasses.replace(
                plan, split=c, adaptive=None), backend="local",
                trace=trace())
            fixed[c].infer(img)                  # its first call, untimed
        zero_counts()
        t0 = time.perf_counter()
        got.append(sess.infer(img))
        wall.append(1e3 * (time.perf_counter() - t0))
        n_l, r_l = read_counts()
        launches += n_l
        routes.update(r_l)
        t0 = time.perf_counter()
        fixed_got.append(fixed[c].infer(img))
        fixed_wall.append(1e3 * (time.perf_counter() - t0))
        ran.append(c)
    routes = dict(routes)
    switches = [(s.request_index, s.old_split, s.new_split)
                for s in sess.switches]
    cpu = serving.connect(plan, backend="local", device="cpu",
                          trace=trace())
    cpu_got = [cpu.infer(img) for img in reqs]
    cpu_switches = [(s.request_index, s.old_split, s.new_split)
                    for s in cpu.switches]
    if not switches or switches != cpu_switches:
        raise AssertionError(f"adaptive: switches {switches} on the card, "
                             f"{cpu_switches} on the CPU")
    if ran != ran_at(sess.switches, plan.split, len(reqs)):
        raise AssertionError(f"adaptive: requests ran at {ran}, switches "
                             f"{switches}")
    want = collections.Counter()
    for c in ran:
        want.update(edge_routes(plan, c))
    if routes != dict(want) or \
            launches != sum(edge_gemm_count(plan, c) for c in ran):
        raise AssertionError(f"adaptive: masked_matmul {launches} launches "
                             f"{routes}, expected {dict(want)}")
    costs = compacted_cnn_layer_costs(plan.cfg, plan.masks)
    rtt = plan.profile.link.rtt_s
    worst_e = 0.0
    for i, (c, g, f, w) in enumerate(zip(ran, got, fixed_got, cpu_got)):
        if not same_bits(g["logits"], f["logits"]) or \
                not g["tx_bytes"] == f["tx_bytes"] == w["tx_bytes"]:
            raise AssertionError(f"adaptive: request {i} at c={c} differs "
                                 f"from the fixed-split session")
        t_s = split_latency(costs, c, plan.profile,
                            cnn_input_bytes(plan.cfg),
                            tx_scale=wire_tx_scale(
                                plan.cfg, plan.masks, c, codec=plan.codec,
                                compact=True))["T_S"]
        e = plan.energy.profile.request_energy(
            g["t_edge"], g["t_upstream"] - t_s, t_s, rtt_s=rtt)
        gap = abs(g["e_edge_j"] - e) / e
        worst_e = max(worst_e, gap)
        if not gap <= 1e-12 or g["e_edge_j"] != w["e_edge_j"]:
            raise AssertionError(f"adaptive: request {i} e_edge_j "
                                 f"{g['e_edge_j']} against {e} (CPU "
                                 f"{w['e_edge_j']})")
    bw = ctl.estimator.bandwidth
    t0 = time.perf_counter()
    for _ in range(200):
        ctl.sweep(bw)
    sweep_us = 1e6 * (time.perf_counter() - t0) / 200
    by_split = collections.defaultdict(list)
    fixed_by_split = collections.defaultdict(list)
    for c, ms, fms in zip(ran[1:], wall[1:], fixed_wall[1:]):
        by_split[c].append(ms)
        fixed_by_split[c].append(fms)
    row = {"plan": "adaptive", "initial_split": plan.split,
           "candidates": list(plan.adaptive.candidates),
           "trace_mbps": [[t, b] for t, b in ADAPTIVE_TRACE],
           "requests": len(reqs), "switches": switches,
           "switches_cpu": cpu_switches,
           "describe": [s.describe() for s in sess.switches],
           "ran_at": ran, "bit_identical_to_fixed_split": True,
           "warmup_launches": warm, "warmup_routes": warm_routes,
           "launches": launches, "routes": routes,
           "e_edge_mj": [1e3 * g["e_edge_j"] for g in got],
           "e_edge_worst_rel_gap": worst_e,
           "battery_j_left": ctl.battery_j,
           "wall_ms_median_by_split": {
               str(c): statistics.median(v) for c, v in by_split.items()},
           "fixed_wall_ms_median_by_split": {
               str(c): statistics.median(v)
               for c, v in fixed_by_split.items()},
           "wall_ms": wall, "fixed_wall_ms": fixed_wall,
           "step_us": step_us, "step_us_median": statistics.median(step_us),
           "sweep_us": sweep_us}
    print("adaptive " + json.dumps(row), flush=True)
    return row, dict(collections.Counter(warm_routes) + collections.Counter(
        routes))


def adaptive_socket(plan, images):
    """Phase 14.4: ``CloudServer(plan)`` + ``connect(plan, "socket")`` on
    127.0.0.1, no link shaper. The loopback's uplink is far faster than
    the plan's Wi-Fi, so the edge's controller offloads (a RESPLIT on the
    live connection, decided, not forced); then a manual ``resplit`` to
    c=19, which the controller adopts. Every row and ``tx_bytes``
    bit-equal to the local backend's at the split it ran at, on one
    connection. Returns (row, routes)."""
    from repro_torch import serving
    plan = dataclasses.replace(plan, port=free_port(), shape_link=False)
    n = len(plan.cfg.layers)
    locals_ = {}

    def local_at(c, img):
        if c not in locals_:
            locals_[c] = serving.connect(dataclasses.replace(
                plan, split=c, adaptive=None), backend="local")
        return locals_[c].infer(img)
    with serving.CloudServer(plan) as server:
        with serving.connect(plan, backend="socket") as sess:
            sock = sess._client.sock
            zero_counts()
            ran, got, wall = [], [], []
            for img in images:
                ran.append(sess.split)
                t0 = time.perf_counter()
                got.append(sess.infer(img))
                wall.append(1e3 * (time.perf_counter() - t0))
            decided = list(sess.switches)
            sess.resplit(n)
            if sess._controller.split != n:
                raise AssertionError("socket adaptive: the controller did "
                                     "not adopt the manual resplit")
            ran.append(sess.split)
            got.append(sess.infer(images[0]))
            launches, routes = read_counts()
            if sess._client.sock is not sock:
                raise AssertionError("socket adaptive: reconnected")
    if not decided:
        raise AssertionError("socket adaptive: the controller never "
                             "switched on the live connection")
    reqs = list(images) + [images[0]]
    for i, (img, c, g) in enumerate(zip(reqs, ran, got)):
        want, tx = expected_frame(dataclasses.replace(plan, split=c),
                                  local_at(c, img))
        if not same_bits(g["logits"], want) or g["tx_bytes"] != tx or \
                g["fault"]["retries"] or not g["e_edge_j"] > 0:
            raise AssertionError(f"socket adaptive: request {i} at c={c} "
                                 f"differs from the local backend")
    want = collections.Counter()
    for c in ran:
        want.update(edge_routes(plan, c))
    if routes != dict(want):
        raise AssertionError(f"socket adaptive: routes {routes}, expected "
                             f"{dict(want)}")
    row = {"plan": "adaptive socket", "initial_split": plan.split,
           "switches": [(s.request_index, s.old_split, s.new_split)
                        for s in decided],
           "manual_resplit": n, "ran_at": ran, "requests": len(reqs),
           "one_connection": True, "bit_identical_to_local": True,
           "server_fault_stats": dict(server.fault_stats),
           "launches": launches, "routes": routes,
           "wall_ms": wall, "e_edge_mj": [1e3 * g["e_edge_j"] for g in got]}
    print("adaptive " + json.dumps(row), flush=True)
    return row, routes


def energy_streaming(plan, images):
    """Phase 14.5: the energy plan through ``connect(plan, "streaming",
    realtime_channel=False)`` at ``microbatch`` 1 and 4: every result's
    ``e_edge_j`` > 0 and the profile's price of the stream's amortized
    stage busy time and its frame share of the modeled uplink, the RTT
    split over the frame's requests. Returns the routes."""
    from repro_torch import serving
    routes = collections.Counter()
    for mb in (1, 4):
        sess = serving.connect(plan, backend="streaming",
                               realtime_channel=False, microbatch=mb)
        zero_counts()
        got = sess.infer_many(images)
        routes.update(read_counts()[1])
        rep = sess.last_report
        n = len(rep.results)
        t_edge = rep.stages["edge"].busy_s / n
        t_cloud = rep.stages["cloud"].busy_s / n
        rtt = plan.profile.link.rtt_s
        for i, (g, r) in enumerate(zip(got, rep.results)):
            e = plan.energy.profile.request_energy(
                t_edge, r["t_tx_model"], t_cloud, rtt_s=rtt / r["frame_n"])
            if not (g["e_edge_j"] == e and e > 0):
                raise AssertionError(f"streaming energy microbatch {mb}: "
                                     f"request {i} {g['e_edge_j']} against "
                                     f"{e}")
        print("energy " + json.dumps({
            "plan": "streaming", "split": plan.split, "microbatch": mb,
            "frames": [len(f) for f in stream_frames(rep)],
            "e_edge_mj": [1e3 * g["e_edge_j"] for g in got]}), flush=True)
    return routes


def adaptive_phase(plans, images, alex_rows):
    """Phase 14: calibration, energy and the adaptive controller on phase
    4's int8 compacted AlexNet plans. Returns the routes of every counted
    run and the c=19 plan's calibration."""
    counted, cal = calibration(plans, images, alex_rows)
    routes = collections.Counter(counted)
    energy, adaptive = adaptive_plans(plans)
    routes.update(adaptive_local(adaptive, images)[1])
    routes.update(adaptive_socket(adaptive, images)[1])
    routes.update(energy_streaming(dataclasses.replace(energy, split=13),
                                   images))
    return routes, cal


# ---------------------------------------------------------------------------
# phase 15: the device model, the roofline and the fleet simulator
# ---------------------------------------------------------------------------
#: the copy's size (bytes) and the GEMM's side
COPY_BYTES = 2 ** 30
GEMM_SIDE = 8192
#: ``benchmarks/fleet_sim.py``'s cells at seed 7: its two fast cells (the
#: first the headline of ``BENCH_fleet.json``), then its five-cell grid
FLEET_CELLS = (("default", 1000, 8, 30.0), ("strict", 1000, 2, 30.0),
               ("default", 1000, 8, 60.0), ("default", 2000, 4, 60.0),
               ("default", 5000, 8, 60.0), ("default", 10000, 16, 60.0),
               ("strict", 10000, 4, 60.0))
FLEET_SEED = 7
#: the record is older than the reference's current arithmetic: two of its
#: float keys differ from today's rollup in the last bits (~1e-15)
FLEET_RECORD_RTOL = 1e-12
FLEET_RECORD = os.path.join(ROOT, "experiments", "bench", "BENCH_fleet.json")


def device_model_phase(smi: str):
    """Phase 15.1: ``roofline.hw`` against the card. The copy moves its
    bytes twice (read, write); the GEMM does 2 x 8192^3 operations. A share
    above 1 is a reading no card can give, and fails."""
    import torch
    props = torch.cuda.get_device_properties(0)
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    src.random_(0, 255)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    if not torch.equal(src[-4096:], dst[-4096:]):
        raise AssertionError("device_model: the copy did not copy")
    del src, dst
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.randn(GEMM_SIDE, GEMM_SIDE, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    b = torch.randn(GEMM_SIDE, GEMM_SIDE, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    c = torch.empty_like(a)
    gemm_ms = time_ms(lambda: torch.matmul(a, b, out=c))
    if not torch.isfinite(c).all():
        raise AssertionError("device_model: the GEMM gave non-finite values")
    del a, b, c
    torch.cuda.empty_cache()
    copy_bytes_s = 2 * COPY_BYTES / (1e-3 * copy_ms)
    gemm_flop_s = 2 * GEMM_SIDE ** 3 / (1e-3 * gemm_ms)
    row = {"card": props.name, "nvidia_smi": smi,
           "sm_count": props.multi_processor_count, "hw_sm_count":
           hw.SM_COUNT, "memory_bytes": props.total_memory,
           "hw_hbm_bytes": hw.HBM_BYTES,
           "l2_bytes": getattr(props, "L2_cache_size", None),
           "hw_l2_bytes": hw.L2_BYTES,
           "copy_bytes": COPY_BYTES, "copy_ms": copy_ms,
           "copy_gb_s": copy_bytes_s / 1e9,
           "copy_share_of_hbm_bw": copy_bytes_s / hw.HBM_BW,
           "gemm": f"bf16 {GEMM_SIDE}^3, torch.matmul (cuBLAS)",
           "gemm_ms": gemm_ms, "gemm_tflop_s": gemm_flop_s / 1e12,
           "gemm_share_of_peak_bf16": gemm_flop_s / hw.PEAK_FLOPS_BF16}
    print("device_model " + json.dumps(row), flush=True)
    for key in ("copy_share_of_hbm_bw", "gemm_share_of_peak_bf16"):
        if not 0.0 < row[key] <= 1.0:
            raise AssertionError(f"device_model: {key} {row[key]} is "
                                 f"outside (0, 1]")
    return row


def roofline_phase(plan, cal):
    """Phase 15.2: the c=19 int8 plan's conv and fc layers on
    ``H100_CARD`` (``quant_edge_roofline``), each beside its calibrated
    time from phase 14 (``cal.layer_s``, one request's cost of the layer
    from an idle card); the unpruned network's total for scale; the edge
    classes' memory-bound check of ``benchmarks/kernel_edge.py``."""
    from repro_torch.core.partition.profiles import (H100_CARD, MCU_EDGE,
                                                     PI_EDGE)
    from repro_torch.roofline.analysis import (check_quant_edge_roofline,
                                               quant_edge_roofline)
    layers = []
    for r in quant_edge_roofline(plan.cfg, plan.masks, H100_CARD):
        bound_s = max(r["t_compute_s"], r["t_memory_s"])
        got_s = cal.layer_s[r["index"]]
        layers.append({"index": r["index"], "name": r["name"],
                       "t_compute_us": 1e6 * r["t_compute_s"],
                       "t_memory_us": 1e6 * r["t_memory_s"],
                       "memory_bound": r["memory_bound"],
                       "roofline_us": 1e6 * bound_s,
                       "calibrated_us": 1e6 * got_s,
                       "calibrated_over_roofline": got_s / bound_s})
    unpruned = quant_edge_roofline(plan.cfg, None, H100_CARD)
    edges = {p.name: min(r["memory_share"] for r in
                         check_quant_edge_roofline(plan.cfg, plan.masks, p)
                         if r["name"].startswith("fc"))
             for p in (MCU_EDGE, PI_EDGE)}
    row = {"plan": "cN", "profile": H100_CARD.name,
           "int8_ops_s": H100_CARD.int8_ops_per_s,
           "mem_bw_bytes_s": H100_CARD.mem_bw, "layers": layers,
           "roofline_us_total": sum(r["roofline_us"] for r in layers),
           "calibrated_us_total": sum(r["calibrated_us"] for r in layers),
           "unpruned_roofline_us_total": 1e6 * sum(
               max(r["t_compute_s"], r["t_memory_s"]) for r in unpruned),
           "edge_fc_min_memory_share": edges}
    print("roofline " + json.dumps(row), flush=True)
    low = [r["name"] for r in layers if r["calibrated_over_roofline"] < 1]
    if low or len(layers) != edge_gemm_count(plan):
        raise AssertionError(f"roofline: layers {low} beat their bound, or "
                             f"{len(layers)} rows for "
                             f"{edge_gemm_count(plan)} GEMM layers")
    return row


def fleet_scenario(mix: str, n_edges: int, n_cloudlets: int,
                   duration_s: float):
    """One cell of ``benchmarks/fleet_sim.py`` (``_scenario``), its strict
    mix (``STRICT_SLO_CLASSES``) written out here."""
    from repro_torch.core.collab.faults import FaultPolicy
    from repro_torch.core.fleet import (DEFAULT_SLO_CLASSES, FleetScenario,
                                        SLOClass)
    strict = (SLOClass("interactive", 0.50,
                       FaultPolicy(request_deadline_s=0.15, fallback="edge",
                                   max_retries=0)),
              SLOClass("standard", 0.50,
                       FaultPolicy(request_deadline_s=0.5, fallback="edge")))
    return FleetScenario(
        name=f"{mix}-{n_edges}x{n_cloudlets}", seed=FLEET_SEED,
        n_edges=n_edges, n_cloudlets=n_cloudlets, duration_s=duration_s,
        slo_classes={"default": DEFAULT_SLO_CLASSES, "strict": strict}[mix])


def hold_to_record(label, got, want, keys):
    """``got[k]`` against the record's ``want[k]`` for each of ``keys``:
    integers exactly, floats within ``FLEET_RECORD_RTOL`` relative. Returns
    the largest relative gap of a float."""
    worst = 0.0
    for k in keys:
        g, w = got[k], want[k]
        if isinstance(g, int):
            ok = isinstance(w, int) and g == w
        else:
            gap = abs(g - w) / max(abs(g), abs(w)) if g != w else 0.0
            worst = max(worst, gap)
            ok = gap <= FLEET_RECORD_RTOL
        if not ok:
            raise AssertionError(f"fleet {label}: {k} {g!r}, the record "
                                 f"{w!r}")
    return worst


def fleet_phase():
    """Phase 15.3: the fleet simulator over ``FLEET_CELLS`` on this
    machine's host (virtual clock; the wall seconds are the host's)."""
    from repro_torch.core.fleet import simulate_fleet
    with open(FLEET_RECORD) as f:
        record = json.load(f)
    rows = []
    for i, cell in enumerate(FLEET_CELLS):
        sc = fleet_scenario(*cell)
        t0 = time.perf_counter()
        got = simulate_fleet(sc)
        wall = time.perf_counter() - t0
        if got["arrivals"] != got["served"] + got["shed"]:
            raise AssertionError(f"fleet {sc.name}: arrivals not conserved")
        row = {"cell": sc.name, "duration_s": sc.duration_s,
               "arrivals": got["arrivals"], "served": got["served"],
               "shed": got["shed"], "latency_p50_s": got["latency_p50_s"],
               "latency_p99_s": got["latency_p99_s"],
               "edge_joules_per_request": got["edge_joules_per_request"],
               "deadline_met_frac": got["deadline_met_frac"],
               "shed_frac": got["shed_frac"],
               "cloudlet_util": got["cloudlet_util"],
               "cloud_util": got["cloud_util"],
               "chaos_reroutes_count": got["chaos_reroutes_count"],
               "wall_s_host": wall}
        if i == 0:              # the headline: the record and a rerun
            extra = set(got) - set(record)
            if extra != {"chaos_reroutes_count"}:
                raise AssertionError(f"fleet: keys {extra} not in the "
                                     f"record")
            row["record_max_rel_gap"] = hold_to_record(
                sc.name, got, record, sorted(set(got) & set(record)))
            for k in ("deadline_met_frac", "shed_frac", "latency_p99_s",
                      "cloud_util"):
                hold_to_record(sc.name, got, {
                    k: record[f"default_1000edges_8cl_{k}"]}, [k])
            if simulate_fleet(fleet_scenario(*cell)) != got:
                raise AssertionError("fleet: a same-seed rerun differs")
            row["rerun_equal"] = True
        if i == 1:              # the record's strict cell
            row["record_max_rel_gap"] = hold_to_record(
                sc.name, got, {k: record[f"strict_1000edges_2cl_{k}"]
                               for k in ("deadline_met_frac", "shed_frac",
                                         "latency_p99_s", "cloud_util")},
                ["deadline_met_frac", "shed_frac", "latency_p99_s",
                 "cloud_util"])
        print("fleet " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def fleet_plan_phase(plan, images):
    """Phase 15.4: ``plan`` with a ``fleet`` section, saved and loaded,
    served on each backend beside the bare plan. Returns the routes of the
    fleet plan's runs."""
    from repro_torch import serving
    sc = serving.FleetScenario(name="orchard", seed=FLEET_SEED,
                               n_edges=1000, n_cloudlets=8, duration_s=30.0)
    # the loopback unshaped, as in phase 11; a port each for the two
    # plans' servers (the port is transport, not contract)
    plan = dataclasses.replace(plan, port=free_port(), shape_link=False)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        made = dataclasses.replace(plan, fleet=sc, port=free_port())
        fleet = serving.DeploymentPlan.load(made.save(d))
        with open(os.path.join(d, "plan.json")) as f:
            stored = json.load(f)
    if not (fleet.digest == made.digest == stored["digest"]
            != plan.digest) or fleet.fleet != sc:
        raise AssertionError(f"fleet_plan: digests {fleet.digest}, "
                             f"{made.digest}, {stored['digest']}, bare "
                             f"{plan.digest}")
    want_routes = {k: v * len(images) for k, v in edge_routes(plan).items()}
    routes, row = collections.Counter(), {
        "plan": "c13", "split": plan.split, "describe": fleet.describe(),
        "digest": fleet.digest, "bare_digest": plan.digest,
        "requests": len(images)}

    def run(p, backend):
        """The requests through ``connect(p, backend)``, counted."""
        extra = ({"realtime_channel": False, "microbatch": 1}
                 if backend == "streaming" else {})
        server = (serving.CloudServer(p) if backend == "socket"
                  else contextlib.nullcontext())
        with server, serving.connect(p, backend=backend, **extra) as sess:
            zero_counts()
            got = ([sess.infer(x) for x in images] if backend == "socket"
                   else sess.infer_many(images))
            return got, read_counts()

    for backend in ("local", "socket", "streaming"):
        bare, _ = run(plan, backend)
        got, (launches, counted) = run(fleet, backend)
        for i, (g, w) in enumerate(zip(got, bare)):
            if not same_bits(g["logits"], w["logits"]) or \
                    g["tx_bytes"] != w["tx_bytes"]:
                raise AssertionError(f"fleet_plan {backend}: request {i} "
                                     f"differs from the bare plan's")
        if len(got) != len(images) or counted != want_routes or \
                launches != edge_gemm_count(plan) * len(images):
            raise AssertionError(f"fleet_plan {backend}: masked_matmul "
                                 f"{launches} launches {counted}, expected "
                                 f"{want_routes}")
        routes.update(counted)
        row[backend] = {"bit_identical_to_bare": True, "launches": launches,
                        "routes": counted, "tx_bytes": got[0]["tx_bytes"]}
    print("fleet_plan " + json.dumps(row), flush=True)
    return routes


# ---------------------------------------------------------------------------
# phase 16: the pruned Mixtral-8x7B (MoE) at full width, its depth cut
# ---------------------------------------------------------------------------
#: Mixtral-8x7B's depth on one card: a layer holds 1.45 G parameters (2.90
#: GB in bf16), so its 32 layers (92.9 GB) do not fit the card's 85 GB;
#: 16 take 46.9 GB with the embedding and the head
MIXTRAL_LAYERS = 16
#: the layers of the three-way logit yardstick (an fp32 copy of 16 does not
#: fit; 4 fp32 layers are 23.2 GB, made from the bf16 ones in place)
MIXTRAL_YARDSTICK_LAYERS = 4
#: R1, and R3: 8192 tokens, twice the 4096-token window, so the prefill
#: skips KV blocks behind the window and the decode cache is the rolling
#: 4096-slot buffer
MIXTRAL_REQUESTS = (("R1", 1, 2048), ("R3", 1, 8192))


def first_layers(params, masks, n: int):
    """The first ``n`` layers of the stack (taken from its runs in order)
    and their masks, as views of the stacked tensors, beside the same
    embedding, final norm and head."""
    def leading(tree):
        return (leading(next(iter(tree.values()))) if isinstance(tree, dict)
                else tree.shape[0])

    def cut(tree, take):
        if isinstance(tree, dict):
            return {k: cut(v, take) for k, v in tree.items()}
        return tree[:take]
    runs, cut_masks = [], []
    for rp, rm in zip(params["runs"], masks):
        take = min(n - sum(leading(r) for r in runs), leading(rp))
        if take <= 0:
            break
        runs.append(cut(rp, take))
        cut_masks.append(None if rm is None else cut(rm, take))
    return {**params, "runs": runs}, cut_masks


def moe_routing(cfg, requests, kern, kroutes, plain, proutes, of_layers):
    """One ``moe_routing`` line a request served by the kernel path
    (``kern``, its routes ``kroutes`` from ``routes_of``) and the bf16
    plain run (``plain``, ``proutes``): each prefill MoE layer's capacity
    and drop_frac (the decode steps' largest drop_frac), the share of (token,
    k) routes on which the two pick the same expert (prefill, each prefill
    layer, decode; one bf16 rounding can move a token past the top-k
    boundary, and a token routed apart differs in every later layer, so
    the share is reported, not held to 1), how many experts a decode
    step's layer sends tokens to, and the two runs' times and logit gap."""
    import torch
    from repro_torch.data.requests import batch_shape
    from repro_torch.models.layers.moe import capacity
    L = moe_layer_count(cfg)
    for (label, batch), kc, pc in zip(requests, kroutes, proutes):
        B, S = batch_shape(cfg, batch)
        kr = [r for r, _ in kc]
        same = [a == b for a, (b, _) in zip(kr, pc)]

        def share(xs):
            return sum(int(x.sum()) for x in xs) / sum(x.numel() for x in xs)
        drop = [d for _, d in kc]
        gap = max(float((g - p).abs().max()) for g, p in zip(
            kern[label]["logits"], plain[label]["logits"]))
        for g in kern[label]["logits"]:
            if g.shape != (B, cfg.padded_vocab) or not bool(
                    torch.isfinite(g).all()):
                raise AssertionError(f"{label}: bad logits {tuple(g.shape)}")
        row = {"model": cfg.name,
               "layers": f"{cfg.num_layers} of {of_layers}",
               "moe_layers": L,
               "request": label, "batch": B, "prompt": S,
               "prefill_capacity": capacity(B * S, cfg.moe),
               "prefill_drop_frac": drop[:L],
               "prefill_drop_frac_mean": statistics.mean(drop[:L]),
               "decode_drop_frac_max": max(drop[L:]),
               "route_agreement_prefill": share(same[:L]),
               "route_agreement_prefill_by_layer": [share([x])
                                                    for x in same[:L]],
               "route_agreement_decode": share(same[L:]),
               "decode_experts_used_per_layer": statistics.mean(
                   len(torch.unique(r)) for r in kr[L:]),
               "prefill_ms": kern[label]["prefill_ms"],
               "decode_ms_median": statistics.median(
                   kern[label]["decode_ms"]),
               "plain_prefill_ms": plain[label]["prefill_ms"],
               "plain_decode_ms_median": statistics.median(
                   plain[label]["decode_ms"]),
               "max_gap_kernel_vs_bf16_plain": gap,
               "launches": kern[label]["launches"],
               "tokens": kern[label]["tokens"].tolist()}
        print("moe_routing " + json.dumps(row), flush=True)


def _leaf_slots(tree):
    """(container, key) of every tensor of nested dicts and lists."""
    for k, v in (tree.items() if isinstance(tree, dict)
                 else enumerate(tree)):
        if isinstance(v, (dict, list)):
            yield from _leaf_slots(v)
        elif v is not None:
            yield tree, k


def float32_in_place(tree):
    """``tree``'s tensors replaced, one at a time and the largest first, by
    float32 copies, each bf16 tensor dropped as its copy is made. Where
    the tree's tensors are views of a served model's stacked tensors
    (``first_layers``), the card never holds a bf16 and a float32 tree
    whole: the peak is the bf16 storage plus the largest float32 tensor.
    Returns ``tree``. (No closure holds the tree: a recursive inner
    function would keep it alive in a reference cycle until the garbage
    collector ran, past the phase.)"""
    import torch
    for t, k in sorted(_leaf_slots(tree),
                       key=lambda tk: -tk[0][tk[1]].numel()):
        t[k] = t[k].to(torch.float32)
        torch.cuda.empty_cache()
    return tree


def moe_phase(phase: str, full, layers: int, yardstick_layers: int,
              requests, yardstick_requests):
    """Phases 16 and 17: the pruned MoE config ``full`` at full width, its
    depth cut to ``layers``, serving ``requests`` through the serving
    steps (the launch counters zeroed just before each request and read
    just after) and through the bf16 plain versions, teacher-forced (a
    ``moe_routing`` line a request); where one prefill of each request and
    one decode step's device time goes; then the logit yardstick of phases
    6-9 on the first ``yardstick_layers`` layers of the same weights at
    ``yardstick_requests``, the MTP block released first (it is never
    run): the yardstick's layers are views of the served model's tensors,
    their float32 copy made tensor by tensor from them
    (``float32_in_place``). A ``<phase>`` line with the phase's seconds
    and the most memory allocated on the card by each part. Returns the
    main path's launch totals."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = full.replace(num_layers=layers)
    params, masks = model_setup(cfg, SEED)
    describe(cfg, params, masks, of_layers=full.num_layers)
    served = request_batches(cfg, requests)
    with watch_moe() as kcalls:
        kern, totals = kernel_path(cfg, params, masks, served)
    kroutes = routes_of(kcalls, len(served))
    torch.cuda.empty_cache()
    with watch_moe() as pcalls:
        plain = {label: serve_tokens(cfg, params, masks, batch, plain=True,
                                     forced=kern[label]["tokens"])
                 for label, batch in served}
    moe_routing(cfg, served, kern, kroutes, plain,
                routes_of(pcalls, len(served)), full.num_layers)
    del kern, kroutes, plain
    torch.cuda.empty_cache()
    for request in requests:
        profile_transformer(cfg, params, masks, request)
    params.pop("mtp", None)
    cut_params, cut_masks = first_layers(params, masks, yardstick_layers)
    del params, masks
    torch.cuda.empty_cache()
    peak = {"served_layers": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    transformer_slice(cfg.replace(num_layers=yardstick_layers), cut_params,
                      cut_masks, yardstick_requests,
                      to_fp32=float32_in_place)
    peak["yardstick"] = torch.cuda.max_memory_allocated() / 1e9
    del cut_params, cut_masks
    torch.cuda.empty_cache()
    print(f"{phase} " + json.dumps({
        "seconds": time.perf_counter() - t0, "peak_allocated_gb": peak,
        "card_gb": torch.cuda.get_device_properties(0).total_memory / 1e9}),
        flush=True)
    return totals


def mixtral_phase():
    """Phase 16: pruned Mixtral-8x7B, MIXTRAL_LAYERS of its 32 layers,
    through ``moe_phase``, the yardstick at R1 and R3."""
    from repro_torch.configs import mixtral_8x7b
    return moe_phase("phase16", mixtral_8x7b.CONFIG, MIXTRAL_LAYERS,
                     MIXTRAL_YARDSTICK_LAYERS, MIXTRAL_REQUESTS,
                     MIXTRAL_REQUESTS)


# ---------------------------------------------------------------------------
# phase 17: the pruned DeepSeek-V3 (MLA, dense layers, then MoE) at full
# width, its depth cut
# ---------------------------------------------------------------------------
#: DeepSeek-V3's depth on one card, in bf16: a dense layer holds 1.17 GB
#: (MLA 0.37, the masked FFN 0.79), an MoE layer 23.0 GB (256 experts of
#: 2048: 22.5), the embedding and head 3.71, the MTP block 1.94. Its 3
#: dense layers and 2 MoE layers take 55.2 GB of the card's 85, and keep an
#: MoE run of more than one layer behind the dense run; a third MoE layer
#: (78.2 GB) would leave no room for R3's activations
DEEPSEEK_LAYERS = 5
#: the yardstick's layers, 3 dense + 1 MoE: their float32 copy (without
#: the MTP block) is 60.5 GB, made tensor by tensor from the bf16 weights
DEEPSEEK_YARDSTICK_LAYERS = 4
#: R1 (2048 tokens: MLA's naive attention, up to naive_attn_max = 4096)
#: and R3 (8192: its chunked attention, 8 KV blocks of 1024)
DEEPSEEK_REQUESTS = (("R1", 1, 2048), ("R3", 1, 8192))


def deepseek_phase():
    """Phase 17: pruned DeepSeek-V3, DEEPSEEK_LAYERS of its 61 layers,
    through ``moe_phase``, the yardstick at R1."""
    from repro_torch.configs import deepseek_v3_671b
    return moe_phase("phase17", deepseek_v3_671b.CONFIG, DEEPSEEK_LAYERS,
                     DEEPSEEK_YARDSTICK_LAYERS, DEEPSEEK_REQUESTS,
                     DEEPSEEK_REQUESTS[:1])


# ---------------------------------------------------------------------------
# phases 18-19: the pruned Qwen2-VL-7B (vision prefix, M-RoPE) and
# HuBERT-XLarge (audio encoder) at full width and depth
# ---------------------------------------------------------------------------
#: Qwen2-VL's requests: (label, batch, sequence), the sequence counting the
#: 1024 vision embeddings before the text (R1: 1024 text tokens; R2: 976)
QWEN2_VL_REQUESTS = (("R1", 1, 2048), ("R2", 2, 2000))
#: the decode steps of the cache-consistency check
CONSISTENCY_STEPS = 4
#: the consistency check's tolerance, relative to the largest logit: the
#: reference's own check (tests/test_decode_consistency.py) holds its
#: float32 smoke stacks to 2e-3
CONSISTENCY_RTOL = 2e-3


def cache_consistency(cfg, params, masks, request):
    """Prefill of ``request``'s sequence but its last CONSISTENCY_STEPS
    tokens, then those tokens by decode steps, against one ``forward``
    over the whole sequence, every call the float32 plain version on the
    card (on a float32 copy of ``params``): the logit rows must agree
    within CONSISTENCY_RTOL of the largest (the same math, other
    summation orders). The M-RoPE ids are the stack's text positions, as
    in the reference's check: a grid prefix's ids and the decode position
    (the sequence length) are not consistent by construction, in the
    reference too. A ``consistency`` line."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.models import transformer as tr
    label, B, S = request
    cfg32 = cfg.replace(dtype="float32")
    params32 = tr.cast_params(params, torch.float32)
    batch = card_batch(cfg32, request_batches(cfg32, [request])[0][1])
    batch.pop("mrope_positions", None)
    tok, n = batch["tokens"], CONSISTENCY_STEPS
    with exact_fp32():
        lg, cache = tr.prefill(params32, cfg32,
                               dict(batch, tokens=tok[:, :-n]), max_len=S,
                               masks=masks, backend="ref")
        rows = [lg]
        for t in range(tok.shape[1] - n, tok.shape[1]):
            lg, cache = tr.decode_step(params32, cfg32, cache,
                                       tok[:, t:t + 1], masks=masks,
                                       backend="ref")
            rows.append(lg)
        del cache
        full = tr.forward(params32, cfg32, batch, masks,
                          backend="ref")[0][:, -n - 1:]
    del params32
    torch.cuda.empty_cache()
    gap = float((torch.stack(rows, 1) - full).abs().max())
    tol = CONSISTENCY_RTOL * max(1.0, float(full.abs().max()))
    row = {"model": cfg.name, "request": label, "batch": B, "prompt": S,
           "decode_steps": n, "max_gap": gap, "tol": tol,
           "max_gap_over_tol": gap / tol}
    print("consistency " + json.dumps(row), flush=True)
    if gap > tol:
        raise AssertionError(f"{cfg.name}: prefill + decode off forward "
                             f"by {gap} > {tol}")


def full_depth_phase(phase: str, cfg, requests):
    """Phases 18 and 19: ``cfg`` pruned at full width and depth (masks at
    ratio 0.5 through ``model_setup``), a ``slice`` line describing it
    (``layers N of N``), each request through the kernel path and the
    bf16 and fp32 plain runs (``transformer_slice``, the launch counters
    zeroed just before each request and read just after), for a decoder
    the cache-consistency check at the first request, ``profile`` lines
    of one prefill (and decode step) of each request, and a ``<phase>``
    line with the phase's seconds and the most memory it allocated.
    Returns the main path's launch totals."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, masks = model_setup(cfg, SEED)
    describe(cfg, params, masks, of_layers=cfg.num_layers)
    _, totals = transformer_slice(cfg, params, masks, requests)
    if cfg.causal:
        cache_consistency(cfg, params, masks, requests[0])
    for request in requests:
        profile_transformer(cfg, params, masks, request)
    del params, masks
    torch.cuda.empty_cache()
    print(f"{phase} " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card_gb": torch.cuda.get_device_properties(0).total_memory / 1e9}),
        flush=True)
    return totals


def qwen2_vl_phase():
    """Phase 18: pruned Qwen2-VL-7B, its 28 layers, R1 and R2 with the
    vision prefix on a 32 x 32 grid, the cache-consistency check at R1."""
    from repro_torch.configs import qwen2_vl_7b
    return full_depth_phase("phase18", qwen2_vl_7b.CONFIG,
                            QWEN2_VL_REQUESTS)


def hubert_phase():
    """Phase 19: pruned HuBERT-XLarge, its 48 layers, R1 (2048 frames) and
    R2 (2 x 1000), prefill only."""
    from repro_torch.configs import hubert_xlarge
    return full_depth_phase("phase19", hubert_xlarge.CONFIG,
                            TRANSFORMER_REQUESTS)


# ---------------------------------------------------------------------------
# phase 20: training the pruned zoo through make_train_step
# ---------------------------------------------------------------------------
#: the training runs: (label, registry module, layers kept, why the depth
#: is cut, batch size, text tokens or frames, steps, AdamW moment dtype).
#: One step holds bf16 parameters and gradients, the moments and the
#: functional update's second copy of them (the reference's before
#: donation): Qwen2-VL's 4 layers (2.02 B parameters) need ~44.5 GB, 8
#: would need ~65; DeepSeek-V3's first (dense) layer and its MTP block
#: (3.41 B) ~48 GB with bf16 moments. Mamba2-2.7B's 64 layers (2.70 B,
#: bf16 moments) fit only since AdamW walks a leaf in slabs
#: (``optim.optimizers.slabwise``): the float32 temporaries of its whole
#: stacked ``w_in`` (1.73 B entries) ran the card out of memory; now ~45
#: GB. Zamba2-1.2B's 38 (1.09 B), fp32 moments: under 40 GB; T2 and T5
#: run half their depth for the script's time
TRAIN_RUNS = (
    ("T1", "qwen2_vl_7b", 4, "a step of 8 layers needs ~65 GB of the "
     "card's 80 (bf16 weights and grads, fp32 moments, the update's "
     "second copy)", 1, 1024, 8, "float32"),
    ("T2", "hubert_xlarge", 24, "the script's time: at 48 layers its "
     "profiles took ~63 s, and phases 21 and 23 grew", 1, 2048, 8,
     "float32"),
    ("T3", "deepseek_v3_671b", 1, "one dense MLA layer and the MTP block "
     "(3.41 B parameters) with bf16 moments: ~48 GB a step", 1, 1024, 2,
     "bfloat16"),
    ("T4", "mamba2_2p7b", 64, None, 1, 2048, 4, "bfloat16"),
    ("T5", "zamba2_1p2b", 19, "the script's time: at 38 layers its "
     "profiles took ~50 s, and phases 21 and 23 grew", 1, 2048, 8,
     "float32"))
#: the constant learning rate of the training runs (AdamW, the reference's
#: defaults otherwise: b1 0.9, b2 0.95, eps 1e-8, clip 1.0)
TRAIN_LR = 1e-4


def train_batch(cfg, B: int, T: int):
    """A numpy training batch of ``cfg`` at step 0 of ``MarkovTokens``: T
    tokens and their labels (the next tokens); a VLM's seeded vision
    embeddings before them, their M-RoPE ids on the square grid; an audio
    config's T seeded frame embeddings, labelled by ``MarkovTokens`` over
    its vocabulary (frame classes)."""
    import math
    import numpy as np
    from repro_torch.data.requests import grid_mrope_positions
    from repro_torch.data.tokens import MarkovTokens
    rng = np.random.default_rng(SEED)
    data = MarkovTokens(cfg.vocab_size, seed=SEED).batch(B, T, 0)
    if cfg.embeds_input:
        return {"embeds": rng.standard_normal((B, T, cfg.d_model),
                                              dtype=np.float32),
                "labels": data["labels"]}
    if cfg.vision_tokens:
        V = cfg.vision_tokens
        data["vision_embeds"] = rng.standard_normal((B, V, cfg.d_model),
                                                    dtype=np.float32)
        data["mrope_positions"] = grid_mrope_positions(B, math.isqrt(V), T)
    return data


def expected_train_launches(cfg, steps: int = 1):
    """Kernel launches of ``steps`` train steps of ``cfg``'s pruned stack:
    each layer's forward kernels (``expected_launches``' prefill counts)
    twice under remat, once in the forward and once in the backward's
    recompute; so is each invocation of a hybrid's shared block (two
    norms and a flash attention; its MLP unmasked); the final norm once;
    an MTP block's two pre-norms, its flash attention and ``mtp.ln`` once
    (outside any checkpoint; its FFN is unmasked). A Mamba2 layer's
    pre-norm, gated norm and scan. Every FFN product on the wgmma tiles (M
    = B * S rows). No backward launches a kernel."""
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.models.layers.mlp import GATED
    from repro_torch.models.transformer import hybrid_split, layer_runs
    remat = 2 if cfg.remat else 1
    attn = sum(r.count for r in layer_runs(cfg) if r.kind != "ssm")
    mla = attn if cfg.attention == "mla" else 0
    ssm = cfg.num_layers - attn
    shared = hybrid_split(cfg, ssm)[0] if cfg.shared_attn_period else 0
    ffn = sum(r.count for r in layer_runs(cfg)
              if r.kind in ("attn", "attn_dense"))
    prods = remat * (2 if cfg.activation in GATED else 1) * ffn
    mtp = 1 if cfg.mtp_depth else 0
    per_step = {"rmsnorm": (remat * (2 * attn + 2 * mla + ssm + 2 * shared)
                            + 1 + 3 * mtp),
                **gated_launches(remat * ssm), "masked_matmul": prods,
                "flash_attention": remat * (attn - mla + shared) + mtp,
                "ssd_scan": remat * ssm,
                **dict.fromkeys(masked_matmul.route_launches, 0),
                "masked_matmul_bf16_tiles": prods}
    return {k: steps * v for k, v in per_step.items()}


def pruned_grads(cfg, grads, masks):
    """The gradient slices of the pruned units, each exactly zero when
    the graph is whole: an FFN's pruned channels (``w_up``, ``w_gate``
    columns, ``w_down`` rows); a GQA layer's pruned heads (``wq``, ``bq``
    columns, ``wo`` rows) and the KV heads of the groups it prunes whole
    (``wk``, ``wv``, ``bk``, ``bv`` columns); an MLA layer's pruned heads
    (their ``w_uq``, ``w_uk``, ``w_uv`` columns, ``wo`` rows); a Mamba2
    layer's pruned SSD heads (``ssd_head_grads``)."""
    from repro_torch.models.transformer import layer_runs
    out = []
    for run, rg, rm in zip(layer_runs(cfg), grads["runs"], masks):
        for j in range(run.count if rm else 0):
            if "ssm_head_mask" in rm:
                out += ssd_head_grads(cfg, {k: t[j] for k, t in
                                            rg["ssm"].items()},
                                      rm["ssm_head_mask"][j] == 0)
                continue
            if "ffn_mask" in rm:
                off = rm["ffn_mask"][j] == 0
                mlp = rg["mlp"]
                out += [mlp["w_up"][j][:, off], mlp["w_down"][j][off]]
                if "w_gate" in mlp:
                    out.append(mlp["w_gate"][j][:, off])
            if "head_mask" not in rm:
                continue
            heads = rm["head_mask"][j] == 0
            a = {k: t[j] for k, t in rg["attn"].items()}
            H = cfg.num_heads
            if cfg.attention == "mla":
                out += [a[name].reshape(a[name].shape[0], H, -1)[:, heads]
                        for name in ("w_uq", "w_uk", "w_uv")]
                out.append(a["wo"].reshape(H, -1, cfg.d_model)[heads])
                continue
            cols = heads.repeat_interleave(cfg.head_dim)
            kv = heads.reshape(cfg.num_kv_heads, -1).all(1) \
                .repeat_interleave(cfg.head_dim)
            out += [a["wq"][:, cols], a["wo"][cols], a["wk"][:, kv],
                    a["wv"][:, kv]]
            out += [a[b][m] for b, m in (("bq", cols), ("bk", kv),
                                         ("bv", kv)) if b in a]
    return out


def ssd_head_grads(cfg, g, heads):
    """The gradient slices of a Mamba2 layer's pruned SSD heads (``heads``
    a bool (H,)), from its ``ssm`` gradients ``g``: their ``w_in`` columns
    of z (``h·P…``), x (``d_inner + h·P…``) and dt (``2·d_inner + 2·G·N +
    h``); their ``conv_w`` and ``conv_b`` x columns; ``dt_bias``,
    ``A_log`` and ``D`` at h; their ``norm_scale`` entries and ``w_out``
    rows. B and C are shared by a group and are not pruned."""
    d_in = cfg.d_inner
    dt0 = 2 * d_in + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    cols = heads.repeat_interleave(cfg.ssm.head_dim)
    w_in = g["w_in"]
    return [w_in[:, :d_in][:, cols], w_in[:, d_in:2 * d_in][:, cols],
            w_in[:, dt0:][:, heads], g["conv_w"][:, :d_in][:, cols],
            g["conv_b"][:d_in][cols], g["dt_bias"][heads], g["A_log"][heads],
            g["D"][heads], g["norm_scale"][cols], g["w_out"][cols]]


def _named_leaves(tree, prefix=""):
    """(dotted path, tensor) of every leaf of nested dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def train_grads(cfg, params, masks, batch, backend: str):
    """(metrics as floats, grads) of ``loss_fn`` on the card
    (``launch.steps.loss_and_grads``): the kernel path (``backend="auto"``)
    or the plain versions (``"ref"``)."""
    from repro_torch.launch.steps import loss_and_grads
    metrics, grads = loss_and_grads(params, cfg, batch, masks, backend)
    return {k: float(v) for k, v in metrics.items()}, grads


def train_grad_check(cfg, params, masks, batch):
    """The loss and every gradient three ways, as phase 6 holds logits:
    the kernel path and the bf16 plain run on ``params``, then the fp32
    plain run on a float32 copy (TF32 off). Each metric, and each leaf's
    relative L2 gap to the fp32 run, must lie within twice the bf16 plain
    run's plus one bf16 spacing; no leaf is skipped, the embedding
    included (a leaf the loss never reads is zero in all three). Every
    pruned unit's gradient on the kernel path must be exactly zero.
    Returns the line's fields."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.models import transformer as tr
    b = card_batch(cfg, batch)
    mk, gk = train_grads(cfg, params, masks, b, "auto")
    leaks = [float(t.abs().max()) for t in pruned_grads(cfg, gk, masks)
             if t.numel()]
    if any(leaks):
        raise AssertionError(f"{cfg.name}: pruned units' gradients on the "
                             f"kernel path reach {max(leaks)}")
    mp, gp = train_grads(cfg, params, masks, b, "ref")
    del b
    params32 = tr.cast_params(params, torch.float32)
    cfg32 = cfg.replace(dtype="float32")
    with exact_fp32():
        m32, g32 = train_grads(cfg32, params32, masks,
                               card_batch(cfg32, batch), "ref")
    del params32
    torch.cuda.empty_cache()
    metrics, worst = {}, 0.0
    for k, f in m32.items():
        tol = 2 * abs(mp[k] - f) + BF16_SPACING * abs(f)
        gap = abs(mk[k] - f)
        metrics[k] = {"kernel": mk[k], "plain_bf16": mp[k], "fp32": f,
                      "gap": gap, "tol": tol}
        worst = max(worst, gap / tol if tol else float(gap > 0) * 1e9)
    leaves = {}
    for (name, k), (_, p), (_, f) in zip(_named_leaves(gk),
                                         _named_leaves(gp),
                                         _named_leaves(g32)):
        norm = float(f.norm())
        if norm == 0.0:
            gap_k, gap_p, tol = float(k.abs().max()), 0.0, 0.0
            ratio = 0.0 if gap_k == 0.0 else float("inf")
        else:
            gap_k = float((k.float() - f).norm()) / norm
            gap_p = float((p.float() - f).norm()) / norm
            tol = 2 * gap_p + BF16_SPACING
            ratio = gap_k / tol
        leaves[name] = {"gap": gap_k, "plain_gap": gap_p, "tol": tol}
        worst = max(worst, ratio)
    del gk, gp, g32
    torch.cuda.empty_cache()
    row = {"metrics": metrics, "grad_gaps": leaves,
           "pruned_grad_slices": len(leaks), "max_gap_over_tol": worst}
    if worst > 1.0:
        raise AssertionError(f"{cfg.name}: the kernel path's loss or "
                             f"gradients off by {worst} of the tolerance: "
                             f"{json.dumps(row)}")
    return row


def train_steps(cfg, model, masks, batch, optimizer, steps: int):
    """``steps`` steps of ``make_train_step`` on one fixed batch, from and
    into ``model["params"]`` (so that no older tree outlives a step), with
    the launch counters zeroed just before and read just after, held to
    ``expected_train_launches``. Returns (losses, wall ms a step,
    launches)."""
    import torch
    from repro_torch.launch.steps import make_train_step
    step = make_train_step(cfg, optimizer, masks)
    state = optimizer.init(model["params"])
    zero_launches()
    losses, walls = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model["params"], state, metrics = step(model["params"], state,
                                               batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
    counts = read_launches()
    want = expected_train_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"{cfg.name}: train launches {counts}, "
                             f"expected {want}")
    return losses, walls, counts


def train_profile(cfg, params, masks, batch, optimizer):
    """Device time of one train step by kernel kind (``device_profile``),
    and of its parts on their own: the forward, the forward and backward
    (``value_and_grad``) and the AdamW update. The backward's time is the
    second less the first."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tr
    step = make_train_step(cfg, optimizer, masks)
    state = optimizer.init(params)
    b = card_batch(cfg, batch)

    def whole():
        step(params, state, batch)
        torch.cuda.synchronize()

    def forward():
        with torch.no_grad():
            tr.loss_fn(params, cfg, b, masks)
        torch.cuda.synchronize()

    def forward_backward():
        train_grads(cfg, params, masks, b, "auto")
        torch.cuda.synchronize()

    def update():
        optimizer.update(held["grads"], state, params)
        torch.cuda.synchronize()
    prof = device_profile(whole)
    parts = {name: device_profile(fn)["device_ms"]
             for name, fn in (("forward_no_grad", forward),
                              ("forward_backward", forward_backward))}
    held = {"grads": train_grads(cfg, params, masks, b, "auto")[1]}
    parts["adamw_update"] = device_profile(update)["device_ms"]
    parts["backward"] = parts["forward_backward"] - parts["forward_no_grad"]
    del held, state
    torch.cuda.empty_cache()
    return prof, parts


def flash_backward_profile(B, S, H, Hkv, D, causal):
    """Device time of one ``flash_attention_backward`` at a training run's
    shape (bf16 operands, fp32 passes), by kind."""
    import torch
    from repro_torch.kernels.flash_attention.ops import \
        flash_attention_backward
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, g = (torch.randn((B, S, H, D), device="cuda", generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), device="cuda", generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))

    def once():
        flash_attention_backward(q, k, v, g, causal, None, D ** -0.5, S)
        torch.cuda.synchronize()
    prof = device_profile(once)
    return {"shape": [B, S, H, Hkv, D], "causal": causal,
            "device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
            "by_kind": prof["by_kind"]}


def ssd_backward_profile(B, S, H, G, P, N, chunk):
    """Device time of one ``ssd_scan_backward`` at a training run's shape
    (bf16 x, B, C as slices of one conv output; a random half of the heads
    pruned; no gradient of the final state, as in training; TF32 off), by
    kind."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_backward
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ops = ssd_inputs(B, S, H, G, P, N, "bfloat16", gen)
    hm = (torch.randperm(H, device="cuda", generator=gen) < H // 2).float()
    dy = torch.randn(B, S, H, P, device="cuda",
                     generator=gen).to(torch.bfloat16)

    def once():
        with exact_fp32():
            ssd_scan_backward(*ops, hm, dy, None, chunk)
        torch.cuda.synchronize()
    prof = device_profile(once)
    return {"shape": [B, S, H, G, P, N], "chunk": chunk,
            "device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
            "by_kind": prof["by_kind"], "top": prof["top"]}


def gated_backward_profile(rows, d, ld):
    """Device time of one ``gated_rmsnorm_backward`` at a training run's
    shape (bf16; z the first d columns of a (rows, ld) projection), by
    kind."""
    import torch
    from repro_torch.kernels.rmsnorm.ops import gated_rmsnorm_backward
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    x, g = (torch.randn(rows, d, device="cuda", generator=gen).to(bf)
            for _ in range(2))
    z = torch.randn(rows, ld, device="cuda", generator=gen).to(bf)[:, :d]
    scale = torch.ones(d, device="cuda", dtype=bf)

    def once():
        gated_rmsnorm_backward(x, z, scale, g)
        torch.cuda.synchronize()
    prof = device_profile(once)
    return {"shape": [rows, d, ld], "device_ms": prof["device_ms"],
            "wall_ms": prof["wall_ms"], "by_kind": prof["by_kind"]}


def backward_profiles(cfg, B, positions):
    """The backwards in PyTorch ops that one train step of ``cfg`` runs,
    each profiled once at the run's shape: the flash attention's where the
    config has attention heads (a hybrid's shared block included), the SSD
    scan's and the gated norm's where it has Mamba2 layers."""
    from repro_torch.models.layers.ssm import conv_dim
    out = {}
    if cfg.num_heads:
        out["flash_backward"] = flash_backward_profile(
            B, positions - (1 if cfg.mtp_depth else 0), cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.causal)
    if cfg.ssm is not None:
        s = cfg.ssm
        out["ssd_backward"] = ssd_backward_profile(
            B, positions, cfg.ssm_heads, s.n_groups, s.head_dim, s.d_state,
            s.chunk_size)
        out["gated_backward"] = gated_backward_profile(
            B * positions, cfg.d_inner,
            cfg.d_inner + conv_dim(cfg) + cfg.ssm_heads)
    return out


def train_run(label, module, layers, cut, B, T, steps, moment_dtype):
    """One training run of phase 20: ``module``'s config pruned at ratio
    0.5 through ``model_setup``, its depth cut to ``layers`` (a ``slice``
    line), the gradient check (``train_grad_check``), ``steps`` AdamW
    steps through ``make_train_step`` on one fixed batch (counted), the
    profiles, and for T1 one step at B = 2 with ``grad_accum`` 2 against
    the same batch at 1. A ``train`` line; returns the launches."""
    import importlib
    import statistics
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import param_count
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import constant
    full = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    cfg = full.replace(num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())
    params, masks = model_setup(cfg, SEED)
    note = f"{layers} of {full.num_layers}" + (
        " + mtp" if cfg.mtp_depth else "")
    describe(cfg, params, masks, of_layers=full.num_layers,
             layers=note, run=label, **({"cut": cut} if cut else {}))
    row = {"model": cfg.name, "run": label, "layers": note,
           "params": param_count(params), "batch": B, "tokens": T,
           "positions": T + (cfg.vision_tokens or 0), "steps": steps,
           "lr": TRAIN_LR, "moment_dtype": moment_dtype}
    batch = train_batch(cfg, B, T)
    lap("setup")
    check = train_grad_check(cfg, params, masks, batch)
    lap("grad_check")
    peaks = {"grad_check": torch.cuda.max_memory_allocated() / 1e9}
    optimizer = adamw(constant(TRAIN_LR),
                      moment_dtype=getattr(torch, moment_dtype))
    if label == "T1":          # B = 2 at grad_accum 2 against 1
        big = train_batch(cfg, 2 * B, T)
        accum = {}
        for n in (1, 2):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step = make_train_step(cfg, optimizer, masks, grad_accum=n)
            m = step(params, optimizer.init(params), big)[2]
            accum[n] = {"loss": float(m["loss"]),
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            del step, m
        gap = abs(accum[2]["loss"] - accum[1]["loss"])
        tol = BF16_SPACING * abs(accum[1]["loss"])
        row["grad_accum"] = {"batch": 2 * B, "accum_1": accum[1],
                             "accum_2": accum[2], "loss_gap": gap,
                             "tol": tol}
        if gap > tol:
            raise AssertionError(f"{cfg.name}: grad_accum 2 loss off "
                                 f"grad_accum 1 by {gap} > {tol}")
    lap("grad_accum")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = {"params": params}
    del params
    losses, walls, launches = train_steps(cfg, model, masks, batch,
                                          optimizer, steps)
    lap("steps")
    peaks["steps"] = torch.cuda.max_memory_allocated() / 1e9
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: loss {losses} did not fall")
    prof, parts = train_profile(cfg, model["params"], masks, batch,
                                optimizer)
    del model
    torch.cuda.empty_cache()
    row.update({"losses": losses, "wall_ms": walls,
                "wall_ms_median": statistics.median(walls),
                "device_ms": prof["device_ms"],
                "device_idle_share": prof["device_idle_share"],
                "by_kind": prof["by_kind"],
                "count_by_kind": prof["count_by_kind"], "top": prof["top"],
                "parts_device_ms": parts, "peak_gb": peaks,
                "launches_per_step": expected_train_launches(cfg),
                **backward_profiles(cfg, B, row["positions"]),
                **check})
    lap("profile")
    row["seconds"] = seconds
    print("train " + json.dumps(row), flush=True)
    return launches


def training_phase():
    """Phase 20: T1 to T5 (``TRAIN_RUNS``), then a ``phase20`` line
    with its seconds and the most memory a run allocated. Returns the
    launches of the counted train steps, by kernel, and of T2 (flash's
    D = 80 instance) apart."""
    import torch
    t0 = time.perf_counter()
    totals, peaks, by_run = None, {}, {}
    for run in TRAIN_RUNS:
        torch.cuda.reset_peak_memory_stats()
        by_run[run[0]] = train_run(*run)
        peaks[run[0]] = torch.cuda.max_memory_allocated() / 1e9
        totals = ({k: totals[k] + v for k, v in by_run[run[0]].items()}
                  if totals else dict(by_run[run[0]]))
    print("phase20 " + json.dumps({
        "seconds": time.perf_counter() - t0, "peak_allocated_gb": peaks,
        "launches": by_run,
        "card_gb": torch.cuda.get_device_properties(0).total_memory / 1e9}),
        flush=True)
    return totals, by_run["T2"]


#: phase 21's sharded steps: phase 20's runs by label, each on the split
#: route (T1's dense attention stack, T3's DeepSeek-V3 dense MLA layer and
#: MTP block, T5's hybrid Zamba2: its SSD heads and shared block), and its
#: depth (None: phase 20's; T5 cut to 12 of 38 layers, two invocations of
#: its shared block, for the script's time: its two device profiles take
#: ~20 s at full depth), and their number of steps
MESH_RUNS = (("T1", None), ("T3", None), ("T5", 12))
MESH_STEPS = 2
#: phase 21's example twins and their arguments: the reference's defaults,
#: but the serve's 8 int8 requests pipelined, a port the OS assigns, and
#: the train twin's checkpoint in a temporary directory
TWINS = (("port_quickstart", []),
         ("port_collaborative_serve",
          ["--requests", "8", "--codec", "int8", "--pipeline"]),
         ("port_prune_and_split", ["--arch", "qwen2-7b"]),
         ("port_train_transformer", ["--arch", "qwen2-7b"]))
#: phase 21's transformer split: tokens of the prefill, and the profiles
SPLIT_SEQ = 4096
SPLIT_PROFILES = ("h100_two_node", "h100_edge_cloud")


def tree_equal(a, b) -> bool:
    import torch
    from repro_torch.optim.optimizers import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def tree_gaps(a, b) -> list:
    """Each leaf's L2 distance between two trees of tensors."""
    from repro_torch.optim.optimizers import tree_leaves
    return [float((x.float() - y.float()).norm())
            for x, y in zip(tree_leaves(a), tree_leaves(b))]


def step_profile(step, params, state, batch) -> dict:
    """``device_profile`` of one more ``step`` from ``params`` and
    ``state`` (its results dropped): wall and device ms, idle share, by
    kind."""
    import torch

    def one_step():
        step(params, state, batch)
        torch.cuda.synchronize()
    prof = device_profile(one_step)
    return {k: prof[k] for k in ("wall_ms", "device_ms", "device_idle_share",
                                 "by_kind")}


def unsharded_steps(cfg, params, masks, batch, optimizer, steps: int,
                    profile: bool = False):
    """(params, losses, profile or None) after ``steps`` steps of the
    unsharded ``make_train_step`` from ``params`` (left as it is), with
    ``step_profile`` of one more step where asked."""
    from repro_torch.launch.steps import make_train_step
    step = make_train_step(cfg, optimizer, masks)
    p, state, losses = params, optimizer.init(params), []
    for _ in range(steps):
        p, state, m = step(p, state, batch)
        losses.append(float(m["loss"]))
    prof = step_profile(step, p, state, batch) if profile else None
    del state
    return p, losses, prof


def check_card_mesh(mesh, shape=(1, 1)) -> None:
    """The host mesh is a one-rank mesh of ``shape`` on the card on NCCL:
    no fallback to the CPU or to gloo."""
    import torch.distributed as dist
    if (dist.get_backend(), mesh.device_type, tuple(mesh.shape)) != (
            "nccl", "cuda", tuple(shape)):
        raise AssertionError(f"host mesh {mesh} on {dist.get_backend()}")


def mesh_train(label, cfg, params, masks, batch, optimizer):
    """A sharded run of phase 21 (``label``, phase 20's run) on the host
    mesh (a one-rank NCCL group it starts and destroys): the step must
    take the split route; ``MESH_STEPS`` counted steps from ``params``,
    held against the unsharded step's, then the step's device profile.
    Returns the ``train`` line's row and the launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.tensor_parallel import ROUTE_SPLIT
    want_route = ROUTE_SPLIT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    want_p, want_losses, want_prof = unsharded_steps(
        cfg, params, masks, batch, optimizer, MESH_STEPS, profile=True)
    want_rise = (torch.cuda.max_memory_allocated() - start) / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    with host_mesh() as mesh:
        check_card_mesh(mesh)
        pspecs = sh.param_specs(params, cfg, mesh)
        s = optimizer.init(params)
        s = sh.distribute(s, sh.opt_state_specs(s, pspecs), mesh)
        p = sh.distribute(params, pspecs, mesh)
        step = make_train_step(cfg, optimizer, masks, mesh=mesh)
        if step.route != want_route:
            raise AssertionError(f"sharded {label} ({cfg.name}) took "
                                 f"{step.route!r}, not the split route")
        zero_launches()
        losses, walls = [], []
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s, m = step(p, s, batch)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        want_launches = expected_train_launches(cfg, MESH_STEPS)
        if launches != want_launches:
            raise AssertionError(f"sharded {label} launches {launches}, "
                                 f"expected {want_launches}")
        prof = step_profile(step, p, s, batch)
        rise = (torch.cuda.max_memory_allocated() - start) / 1e9
        step_route = step.route
        got_p = sh.tree_map_with_path(lambda _, t: t.full_tensor(), p)
        del p, s, step
        torch.cuda.empty_cache()
        row = {"model": cfg.name, "run": f"{label} mesh",
               "steps": MESH_STEPS,
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "backend": dist.get_backend(), "losses": losses,
               "unsharded_losses": want_losses, "wall_ms": walls,
               "launches": launches, "peak_gb": peak,
               # the peak above the memory held before the run, each run
               # from its optimizer's init through its profiled step
               "steps_peak_rise_gb": rise,
               "unsharded_steps_peak_rise_gb": want_rise,
               "route": step_route,
               **{k: prof[k] for k in ("device_ms", "device_idle_share",
                                       "by_kind")},
               "profile_wall_ms": prof["wall_ms"],
               "unsharded_profile": want_prof}
        row["bit_equal"] = (losses == want_losses
                            and tree_equal(got_p, want_p))
        if not row["bit_equal"]:
            # the card's own spread: the unsharded step run again
            again_p, again_losses, _ = unsharded_steps(
                cfg, params, masks, batch, optimizer, MESH_STEPS)
            spread = tree_gaps(again_p, want_p)
            gaps = tree_gaps(got_p, want_p)
            moved = tree_gaps(want_p, params)
            worst = max((g / (2 * sp + BF16_SPACING * mv) if g else 0.0)
                        for g, sp, mv in zip(gaps, spread, moved))
            loss_tol = [2 * abs(a - w) + BF16_SPACING * abs(w)
                        for a, w in zip(again_losses, want_losses)]
            row.update(unsharded_rerun_bit_equal=(
                again_losses == want_losses
                and tree_equal(again_p, want_p)),
                max_gap_over_tol=worst, loss_tol=loss_tol)
            del again_p
            if worst > 1.0 or any(abs(g - w) > t for g, w, t in zip(
                    losses, want_losses, loss_tol)):
                raise AssertionError(f"sharded {label} off the unsharded "
                                     f"step: {json.dumps(row)}")
        del got_p, want_p
    if dist.is_initialized():
        raise AssertionError("the host mesh's group outlived the phase")
    torch.cuda.empty_cache()
    return row, launches


def run_twins() -> dict:
    """Each example twin's ``main`` on the card (``TWINS``), its own lines
    between a start line and a ``twin`` line with its seconds and the
    transformer kernels' launches; a twin that fails fails the run.
    Returns the launches summed over the twins."""
    import importlib.util
    import shutil
    totals = collections.Counter()
    ckpt = tempfile.mkdtemp(prefix="port_train_")
    try:
        for name, argv in TWINS:
            if name == "port_collaborative_serve":
                argv = argv + ["--port", str(free_local_port())]
            if name == "port_train_transformer":
                argv = argv + ["--ckpt", os.path.join(ckpt, "t")]
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(ROOT, "examples", f"{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            print(f"twin {name} start {json.dumps(argv)}", flush=True)
            zero_launches()
            t0 = time.perf_counter()
            mod.main(argv)
            launches = read_launches()
            totals.update(launches)
            print("twin " + json.dumps({
                "name": name, "argv": argv,
                "seconds": time.perf_counter() - t0,
                "launches": {k: v for k, v in launches.items() if v}}),
                flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return dict(totals)


def free_local_port() -> int:
    """A TCP port the OS assigns on 127.0.0.1."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def split_lines() -> None:
    """The transformer split of every registry config (full size) under
    ``SPLIT_PROFILES``, at a ``SPLIT_SEQ``-token prefill and a decode step
    against that context, greedy and balanced: one ``split`` line a
    config."""
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.core.partition.latency_model import \
        transformer_layer_costs
    from repro_torch.core.partition.profiles import PROFILES
    from repro_torch.core.partition.splitter import (balanced_split,
                                                     greedy_split)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        row = {"model": cfg.name, "layers": cfg.num_layers}
        for mode, decode in (("prefill", False), ("decode", True)):
            costs = transformer_layer_costs(cfg, SPLIT_SEQ, decode=decode)
            inp = (1 if decode else SPLIT_SEQ) * cfg.d_model * 2
            for prof in SPLIT_PROFILES:
                g = greedy_split(costs, PROFILES[prof], inp)
                b = balanced_split(costs, PROFILES[prof], inp)
                row[f"{prof} {mode}"] = {
                    "greedy_c": g.split_point,
                    **{f"{k}_ms": 1e3 * g.latency[k]
                       for k in ("T", "T_D", "T_TX", "T_S")},
                    "balanced_c": b.split_point,
                    "balanced_bottleneck_ms": 1e3 * max(
                        b.latency["T_D"], b.latency["T_TX"],
                        b.latency["T_S"])}
        print("split " + json.dumps(row), flush=True)


def mesh_phase() -> dict:
    """Phase 21: the sharded T1, T3 and T5 steps on the host mesh against
    the unsharded ones (``MESH_RUNS``, each on the split route), the four
    example twins on the card, the transformer split lines
    and a ``phase21`` line. Returns the launches of the sharded steps and
    the twins, by kernel and route."""
    import importlib
    import torch
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import constant
    t0 = time.perf_counter()
    total, seconds = collections.Counter(), {}
    for label, depth in MESH_RUNS:
        t_run = time.perf_counter()
        _, module, layers, _, B, T, _, moment_dtype = next(
            r for r in TRAIN_RUNS if r[0] == label)
        layers = depth or layers
        full = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
        cfg = full.replace(num_layers=layers)
        params, masks = model_setup(cfg, SEED)
        describe(cfg, params, masks, of_layers=full.num_layers,
                 layers=f"{layers} of {full.num_layers}", run=f"{label} mesh")
        optimizer = adamw(constant(TRAIN_LR),
                          moment_dtype=getattr(torch, moment_dtype))
        row, launches = mesh_train(label, cfg, params, masks,
                                   train_batch(cfg, B, T), optimizer)
        row.update(batch=B, tokens=T,
                   positions=T + (cfg.vision_tokens or 0))
        print("train " + json.dumps(row), flush=True)
        total.update(launches)
        del params, masks
        torch.cuda.empty_cache()
        seconds[f"seconds_sharded_{label.lower()}"] = (time.perf_counter()
                                                      - t_run)
    t_twins = time.perf_counter()
    twin_launches = run_twins()
    t_split = time.perf_counter()
    split_lines()
    total.update(twin_launches)
    print("phase21 " + json.dumps({
        "seconds": time.perf_counter() - t0, **seconds,
        "seconds_twins": t_split - t_twins,
        "launches": dict(total)}), flush=True)
    return dict(total)

#: phase 22: the pipelined split served on the card at the reference's
#: split-serve defaults (``dryrun.run_split_serve``): full width and depth
SPLIT_SERVE_MODELS = ("qwen2_7b", "mamba2_2p7b")
SPLIT_SERVE_BATCH = 32
SPLIT_SERVE_SEQ = 4096
SPLIT_SERVE_MICROBATCHES = 8
#: rows of the batch the bf16 and fp32 plain yardsticks run (the fp32
#: Qwen2-7B tree alone is 30.5 GB)
SPLIT_YARDSTICK_ROWS = 2
#: the dry-run cell phase 22 traces on this machine, in a subprocess
DRYRUN_CELL = ("qwen2-7b", "decode_32k", "pod")
#: each split serve's peak GB when its stage was gathered whole (PR 27's
#: run ``final27``), printed beside the split route's
SPLIT_PEAK_GB_FINAL27 = {"qwen2_7b": 35.17, "mamba2_2p7b": 14.07}


def expected_split_launches(cfg, microbatches: int) -> dict:
    """Kernel launches of one split-serve step with one pod: every layer's
    kernels once a microbatch (an attention layer two norms and a flash
    attention, a Mamba2 layer a norm, a gated norm and a scan; no masks,
    so no ``masked_matmul``), and the final norm once over the whole
    batch."""
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.models.transformer import layer_runs
    attn = sum(r.count for r in layer_runs(cfg) if r.kind != "ssm")
    ssm = cfg.num_layers - attn
    return {"rmsnorm": (2 * attn + ssm) * microbatches + 1,
            **gated_launches(ssm * microbatches), "masked_matmul": 0,
            "flash_attention": attn * microbatches,
            "ssd_scan": ssm * microbatches,
            **dict.fromkeys(masked_matmul.route_launches, 0)}


def dryrun_subprocess(args, out_dir: str):
    """``python -m repro_torch.launch.dryrun`` with ``args`` in a process
    of its own (its fake process group never meets this one's NCCL
    group), on the CPU, started now; ``finish_dryrun`` waits for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
           "--out", out_dir]
    return subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_dryrun(proc, record: str) -> dict:
    """The record a ``dryrun_subprocess`` wrote; its output on failure."""
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0 or not os.path.exists(record):
        raise AssertionError(f"dry run failed ({proc.returncode}): "
                             f"{out[-3000:]}")
    with open(record) as f:
        return json.load(f)


def split_serve_model(cfg, mesh) -> dict:
    """One model of phase 22: the same batch through ``make_prefill_step``
    and through ``make_split_serve_step`` on ``mesh`` (one pod, the
    reference's microbatches, its stage on the split route), both on the
    kernels; their last-position logits held to each other (bit for bit:
    on one rank every fetch is a view and every reduction the identity)
    and to fp32 (the LM-logits rule of PERF.md §2, the bf16 and fp32
    plain yardsticks run on the first ``SPLIT_YARDSTICK_ROWS`` rows); wall
    and device ms of each, peaks, the split step's launches. Returns the
    ``split_serve`` line's row and the launches; ``split_serve_phase``
    prints and holds the row."""
    import numpy as np
    import torch
    from repro_torch.core.partition import pod_pipeline as pp
    from repro_torch.data.requests import request_batch
    from repro_torch.device import exact_fp32
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import specs as sh
    B, S, M = SPLIT_SERVE_BATCH, SPLIT_SERVE_SEQ, SPLIT_SERVE_MICROBATCHES
    # the model_setup weights; the split step takes no masks
    params, _ = model_setup(cfg, SEED)
    n_params = tr.param_count(params)
    batch = request_batch(cfg, B, S, np.random.default_rng(SEED))
    prefill = make_prefill_step(cfg, max_len=S)

    def run_prefill():
        lg, cache = prefill(params, batch)
        torch.cuda.synchronize()
        del cache
        return lg
    sp = dict(params)
    sp["runs"] = [pp.stack_stage_params(params, cfg, 1)]
    placed = sh.distribute(sp, pp.stage_param_specs(sp, cfg, mesh), mesh)
    step = pp.make_split_serve_step(cfg, 1, M, mesh)
    route = step.route
    if route != pp.ROUTE:
        raise AssertionError(f"{cfg.name}: the split serve took route "
                             f"{route!r}")

    def run_split():
        lg = step(placed, batch)
        torch.cuda.synchronize()
        return lg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    want = run_prefill().float()
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    got = run_split().float()
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    split_peak = torch.cuda.max_memory_allocated() / 1e9
    expected = expected_split_launches(cfg, M)
    if launches != expected:
        raise AssertionError(f"{cfg.name} split serve launches {launches}, "
                             f"expected {expected}")
    if got.shape != (B, cfg.padded_vocab) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{cfg.name}: bad split logits "
                             f"{tuple(got.shape)}")
    prof_pre = device_profile(run_prefill)
    prof_split = device_profile(run_split)
    del placed, step, sp
    torch.cuda.empty_cache()
    # the yardsticks: the plain versions in bf16, then in fp32, on the
    # first rows
    rows = {k: v[:SPLIT_YARDSTICK_ROWS] for k, v in batch.items()}
    plain = tr.prefill(params, cfg, card_batch(cfg, rows), max_len=S,
                       backend="ref")[0].float()
    torch.cuda.empty_cache()
    params32 = tr.cast_params(params, torch.float32)
    del params
    torch.cuda.empty_cache()
    with exact_fp32():
        f = tr.prefill(params32, cfg.replace(dtype="float32"),
                       card_batch(cfg.replace(dtype="float32"), rows),
                       max_len=S, backend="ref")[0].float()
    del params32
    torch.cuda.empty_cache()
    n = SPLIT_YARDSTICK_ROWS
    gap_p = float((plain - f).abs().max())
    tol = 2 * gap_p + BF16_SPACING * float(f.abs().max())
    gaps = {"split_vs_prefill": float((got - want).abs().max()),
            "split_vs_fp32": float((got[:n] - f).abs().max()),
            "prefill_vs_fp32": float((want[:n] - f).abs().max()),
            "bf16_plain_vs_fp32": gap_p}
    worst = max(gaps[k] for k in ("split_vs_prefill", "split_vs_fp32",
                                  "prefill_vs_fp32")) / tol
    row = {"model": cfg.name, "layers": cfg.num_layers,
           "params": n_params, "batch": B,
           "prompt": S, "microbatches": M, "pods": 1,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "route": route,
           "bit_equal_to_prefill": bool(torch.equal(got, want)),
           "max_gap": gaps, "tol": tol, "max_gap_over_tol": worst,
           "launches": {k: v for k, v in launches.items() if v},
           "split_first_call_ms": first_ms,
           "split_wall_ms": prof_split["wall_ms"],
           "split_device_ms": prof_split["device_ms"],
           "split_idle_share": prof_split["device_idle_share"],
           "split_by_kind": prof_split["by_kind"],
           "prefill_wall_ms": prof_pre["wall_ms"],
           "prefill_device_ms": prof_pre["device_ms"],
           "prefill_idle_share": prof_pre["device_idle_share"],
           "prefill_by_kind": prof_pre["by_kind"],
           "split_peak_gb": split_peak, "prefill_peak_gb": prefill_peak}
    return row, launches


def beside_dryrun(row, dry_split) -> None:
    """The dry run's terms for the served step (one-rank fake mesh, plain
    route) beside the measured device time."""
    terms = dry_split["roofline"]
    top = max(("t_compute_s", "t_memory_s", "t_collective_s"),
              key=terms.get)
    row["dryrun"] = {
        "mesh": dry_split["mesh"], "model_axis": dry_split["model_axis"],
        "dominant": terms["dominant"],
        "largest_term_ms": 1e3 * terms[top],
        "t_compute_ms": 1e3 * terms["t_compute_s"],
        "t_memory_ms": 1e3 * terms["t_memory_s"],
        "flops": terms["flops"], "bytes_unfused": terms["hbm_bytes"],
        "peak_gb": dry_split["memory_analysis"]["peak_bytes_per_card"] / 1e9,
        "measured_device_over_largest_term":
            row["split_device_ms"] / (1e3 * terms[top]),
        "measured_device_over_compute_term":
            row["split_device_ms"] / (1e3 * terms["t_compute_s"])}


def split_serve_phase() -> dict:
    """Phase 22: the pipelined split (``core.partition.pod_pipeline``) on
    the card's one-rank NCCL (1, 1, 1) ("pod", "data", "model") mesh for
    Qwen2-7B and Mamba2-2.7B at full width and depth, each against the
    prefill step; one dry-run cell (``DRYRUN_CELL``) and the split serve
    of Qwen2-7B on a one-rank fake mesh traced in subprocesses meanwhile;
    a ``dryrun`` line and a ``phase22`` line. Returns the split steps'
    launches."""
    import importlib
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.core.partition import pod_pipeline as pp
    from repro_torch.launch.mesh import host_mesh
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    arch, shape, mesh_name = DRYRUN_CELL
    try:
        cell = dryrun_subprocess(["--arch", arch, "--shape", shape,
                                  "--mesh", mesh_name], tmp)
        served = dryrun_subprocess(["--arch", "qwen2-7b", "--split-serve",
                                    "--pods-mesh", "1x1x1"], tmp)
        total = collections.Counter()
        with host_mesh(pod_axis=True) as mesh:
            check_card_mesh(mesh, (1, 1, 1))
            for module in SPLIT_SERVE_MODELS:
                cfg = importlib.import_module(
                    f"repro_torch.configs.{module}").CONFIG
                row, launches = split_serve_model(cfg, mesh)
                row["split_peak_gb_final27"] = SPLIT_PEAK_GB_FINAL27[module]
                if module == "qwen2_7b":
                    beside_dryrun(row, finish_dryrun(served, os.path.join(
                        tmp, "torch_qwen2-7b_split_serve_1x1x1.json")))
                print("split_serve " + json.dumps(row), flush=True)
                if row["max_gap_over_tol"] > 1.0:
                    raise AssertionError(
                        f"{cfg.name}: split-serve logits off by "
                        f"{row['max_gap_over_tol']} of the tolerance")
                if not row["bit_equal_to_prefill"]:
                    raise AssertionError(f"{cfg.name}: the split serve is "
                                         f"not the prefill's bits")
                if module == "qwen2_7b" and \
                        row["dryrun"]["model_axis"] != pp.ROUTE:
                    raise AssertionError(
                        f"the split serve's dry run took route "
                        f"{row['dryrun']['model_axis']!r}")
                total.update(launches)
                torch.cuda.empty_cache()
        if dist.is_initialized():
            raise AssertionError("the pod mesh's group outlived the phase")
        rec = finish_dryrun(cell, os.path.join(
            tmp, f"torch_{arch}_{shape}_{mesh_name}.json"))
        print("dryrun " + json.dumps({
            "cell": list(DRYRUN_CELL), "status": rec["status"],
            "trace_s": rec["trace_s"], "chips": rec["chips"],
            "dominant": rec["roofline"]["dominant"],
            "roofline": rec["roofline"],
            "collectives": rec["collectives"]["bytes_by_op"],
            "peak_gb": rec["memory_analysis"]["peak_bytes_per_card"] / 1e9,
            "fits": rec["memory_analysis"]["fits"]}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase22 " + json.dumps({
        "seconds": time.perf_counter() - t0, "launches": dict(total)}),
        flush=True)
    return dict(total)

#: phase 23: tensor parallelism over "model" for the attention stacks
TP_REQUEST = ("R1", 1, 2048)
#: (a) and (b): Qwen2-7B's layers kept (14 of 28, for the script's time)
TP_QWEN_LAYERS = 14
#: (b)'s and (d)'s split: "model" ranks run one after another, and the
#: decode steps of (b), (c) and (d)
TP_RANKS = 2
TP_DECODE_STEPS = 4
#: (c) and (d): the MoE stacks at full width, (registry module, layers
#: kept): Mixtral-8x7B 4 of 32; DeepSeek-V3 its 3 dense layers and 1 MoE
#: layer (~30 GB: one MoE layer is 23.0 GB)
TP_MOE_RUNS = (("mixtral_8x7b", 4), ("deepseek_v3_671b", 4))
#: (e): Mixtral-8x7B at "model" = 16 rank after rank: (layers, ranks,
#: decode steps); the only run on the card of two ranks an expert and of a
#: KV cache on the head dim (8 KV heads on 16 ranks)
TP_WIDE = (2, 16, 2)
#: (f) and (g): Mamba2-2.7B's layers kept (8 of 64, for the script's
#: time); (h): its (layers, ranks) on "model" = 16, the pod's own split (5
#: SSD heads and 320 gated-norm columns a rank)
TP_MAMBA_LAYERS = 8
TP_MAMBA_WIDE = (2, 16)


def tp_one_rank(cfg, params, masks, batch, steps: int = DECODE_STEPS,
                part: str = "a") -> dict:
    """Phase 23 (a) and (c): an R1 prefill and ``steps`` greedy decode
    steps through the mesh steps on the one-rank NCCL host mesh (the split
    route: every fetch a view, every reduction the identity) against the
    unsharded steps: the same logits bit for bit, the same tokens and
    launches; each run's wall ms, device ms (one traced run) and peak."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.tensor_parallel import ROUTE_SPLIT

    def request(prefill, decode, p, local):
        lg, cache = prefill(p, batch)
        out = [local(lg)]
        for _ in range(steps):
            lg, cache = decode(p, cache, out[-1].argmax(-1, keepdim=True))
            out.append(local(lg))
        torch.cuda.synchronize()
        return out

    def measured(prefill, decode, p, local):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        zero_launches()
        t0 = time.perf_counter()
        out = [t.float() for t in request(prefill, decode, p, local)]
        wall = 1e3 * (time.perf_counter() - t0)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        prof = device_profile(lambda: request(prefill, decode, p, local))
        return out, {"wall_ms": wall, "device_ms": prof["device_ms"],
                     "profile_wall_ms": prof["wall_ms"],
                     "device_idle_share": prof["device_idle_share"],
                     "peak_gb": peak / 1e9,
                     "peak_rise_gb": (peak - start) / 1e9,
                     "launches": launches}
    B, S = TP_REQUEST[1:]
    max_len = S + steps
    torch.cuda.empty_cache()
    want, base = measured(make_prefill_step(cfg, max_len=max_len,
                                            masks=masks),
                          make_decode_step(cfg, masks=masks), params,
                          lambda t: t)
    with host_mesh() as mesh:
        check_card_mesh(mesh)
        p = sh.distribute(params, sh.param_specs(params, cfg, mesh), mesh)
        prefill = make_prefill_step(cfg, max_len=max_len, masks=masks,
                                    mesh=mesh)
        decode = make_decode_step(cfg, masks=masks, mesh=mesh)
        if (prefill.route, decode.route) != (ROUTE_SPLIT, ROUTE_SPLIT):
            raise AssertionError(f"{cfg.name} on the mesh took "
                                 f"{prefill.route!r}")
        got, row = measured(prefill, decode, p, lambda t: t.to_local())
        del p, prefill, decode
    if dist.is_initialized():
        raise AssertionError("the host mesh's group outlived the phase")
    torch.cuda.empty_cache()
    want_launches = expected_launches(cfg, steps)
    row.update(route=ROUTE_SPLIT, mesh={"data": 1, "model": 1},
               unsharded=base,
               bit_equal=all(torch.equal(a, b) for a, b in zip(got, want)),
               tokens_equal=all(torch.equal(a.argmax(-1), b.argmax(-1))
                                for a, b in zip(got, want)))
    if not row["bit_equal"] or row["launches"] != base["launches"] \
            or base["launches"] != want_launches:
        raise AssertionError(f"phase 23 ({part}) off the unsharded steps: "
                             f"{json.dumps(row)}")
    return row


def tp_shares(cfg, params, masks, batch, m: int, steps: int) -> dict:
    """Phase 23 (b), (d) and (e): the ``m``-rank split of ``cfg`` over
    "model" on the card, each rank's share run in turn through
    ``SequentialRanks`` (every row product's partial sums added in rank
    order): an R1 prefill and ``steps`` greedy decode steps through the
    stack with ``tp``, every layer at the rank's shapes (its heads, FFN
    columns, experts and vocabulary). Returns each rank's logits, the
    tokens, rank 0's MoE routes, the ms of the run and its launches, which
    must be ``m`` times one request's."""
    import torch
    from repro_torch.data.requests import batch_shape
    from repro_torch.models import transformer as tr
    from repro_torch.sharding.tensor_parallel import (SequentialRanks,
                                                      TensorParallel)
    B, S = batch_shape(cfg, batch)
    ranks = SequentialRanks(m)
    shares = [TensorParallel.sliced(cfg, params, a) for a in ranks.axes()]
    on_card = card_batch(cfg, batch)

    def run(tp):
        lg, cache = tr.prefill(params, cfg, on_card, max_len=S + steps,
                               masks=masks, tp=tp)
        out, fed = [lg.float()], []
        for _ in range(steps):
            nxt = lg.argmax(-1, keepdim=True)
            fed.append(nxt)
            lg, cache = tr.decode_step(params, cfg, cache, nxt, masks=masks,
                                       tp=tp)
            out.append(lg.float())
        return out, torch.cat(fed, 1)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), watch_moe() as calls:
        res = ranks.run([lambda tp=tp: run(tp) for tp in shares])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    one = expected_launches(cfg, steps, split=m > 1)
    want = {k: m * v for k, v in one.items()}
    if launches != want:
        raise AssertionError(f"phase 23 split launches {launches}, "
                             f"expected {want}")
    for out, tok in res[1:]:
        if not (torch.equal(tok, res[0][1]) and all(
                torch.equal(a, b) for a, b in zip(out, res[0][0]))):
            raise AssertionError("phase 23: the ranks' logits differ")
    shapes = [{"rank": tp.axis.rank, "vocab": tp.vocab} for tp in shares]
    for row, tp in zip(shapes, shares):
        if tp.heads is not None:
            row.update(heads=tp.heads.q, kv_heads=tp.heads.kv, ffn=tp.ffn,
                       kv_cache=tp.kv_layout)
        if tp.ssd is not None:
            row.update(ssd_heads=tp.ssd.q, groups=tp.ssd.kv,
                       state_cache=tp.state_layout,
                       conv_cache=tp.conv_layout)
        if cfg.moe is not None:
            row["experts"], row["expert_cols"] = tp.experts
        if cfg.attention == "mla":
            row["latent_cache"] = tp.latent_layouts
    return {"logits": res[0][0], "tokens": res[0][1], "ms": ms,
            "routes": routes_of(calls, 1)[0], "launches": launches,
            "shapes": shapes}


def tp_held(cfg, params, masks, batch, split, steps: int) -> dict:
    """A split's logits (``tp_shares``) held to the LM phases' rule against
    the unsharded plain runs in bf16 and fp32, teacher-forced with its
    tokens: no farther from the fp32 run than twice the bf16 plain run
    is, plus one bf16 spacing of the largest logit. In an MoE stack both
    plain runs take the split's own routes (``routes_forced``), so every
    step is held: routing is discontinuous, and one bf16 rounding in a
    norm or an attention can move a token past the top-k boundary, which
    the rule is not about. The share of (token, k) routes the split and
    the unsharded kernel path pick alike is reported, and the steps whose
    own tokens they routed apart in some layer (``flipped_steps``).
    ``params`` end as float32 (``float32_in_place``). Returns the row."""
    import torch
    from repro_torch.data.requests import batch_shape
    from repro_torch.device import exact_fp32
    with watch_moe() as kcalls:
        kern = serve_tokens(cfg, params, masks, batch,
                            forced=split["tokens"], steps=steps)
    kroutes = routes_of(kcalls, 1)[0]
    with routes_forced(split["routes"]):
        plain = serve_tokens(cfg, params, masks, batch, plain=True,
                             forced=split["tokens"], steps=steps)
    float32_in_place(params)
    with exact_fp32(), routes_forced(split["routes"]):
        fp32 = serve_tokens(cfg.replace(dtype="float32"), params, masks,
                            batch, plain=True, forced=split["tokens"],
                            steps=steps)
    torch.cuda.empty_cache()
    worst, gaps = 0.0, []
    for g, k, p, f in zip(split["logits"], kern["logits"], plain["logits"],
                          fp32["logits"]):
        if g.shape != (1, cfg.padded_vocab) or not bool(
                torch.isfinite(g).all()):
            raise AssertionError(f"phase 23: bad logits {g.shape}")
        gap = float((g - f).abs().max())
        tol = (2 * float((p - f).abs().max())
               + BF16_SPACING * float(f.abs().max()))
        worst = max(worst, gap / tol)
        gaps.append({"split_vs_fp32": gap, "tol": tol,
                     "split_vs_unsharded_kernel": float((g - k).abs().max()),
                     "unsharded_kernel_vs_fp32": float((k - f).abs().max())})
    row = {"shapes": split["shapes"], "ms": split["ms"],
           "unsharded_prefill_ms": kern["prefill_ms"],
           "unsharded_decode_ms": kern["decode_ms"],
           "launches": split["launches"], "gaps": gaps,
           "max_gap_over_tol": worst, "held_steps": len(gaps),
           "tokens": split["tokens"].tolist()}
    if cfg.moe is not None:
        same = [a == b for (a, _), (b, _) in zip(split["routes"], kroutes)]
        flips = flipped_steps(cfg, batch_shape(cfg, batch), split["routes"],
                              kroutes, steps)
        row.update(
            route_agreement=(sum(int(x.sum()) for x in same)
                             / sum(x.numel() for x in same)),
            flipped_steps=[i for i, f in enumerate(flips) if f],
            split_drop_frac=[d for _, d in split["routes"]],
            unsharded_drop_frac=[d for _, d in kroutes])
    if worst > 1.0:
        raise AssertionError(f"phase 23: {cfg.name}'s split logits off by "
                             f"{worst} of the tolerance")
    return row


def tp_moe_run(module: str, layers: int, totals) -> None:
    """Phase 23 (c) and (d) for one MoE stack (``TP_MOE_RUNS``): the
    pruned config at full width, ``layers`` deep, the MTP block released
    (serving never runs it); (c) on the one-rank mesh against the
    unsharded steps (``tp_one_rank``), (d) the ``TP_RANKS``-rank split
    rank after rank, held by ``tp_held``. A ``tensor_parallel`` line
    each; their launches added to ``totals``."""
    import importlib
    import torch
    full = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    cfg = full.replace(num_layers=layers)
    params, masks = model_setup(cfg, SEED)
    params.pop("mtp", None)
    describe(cfg, params, masks, of_layers=full.num_layers,
             run="tensor parallel")
    (_, batch), = request_batches(cfg, [TP_REQUEST])
    t0 = time.perf_counter()
    row = tp_one_rank(cfg, params, masks, batch, TP_DECODE_STEPS, "c")
    row["seconds"] = time.perf_counter() - t0
    print("tensor_parallel " + json.dumps({
        "part": "c", "model": cfg.name, "layers": f"{layers} of "
        f"{full.num_layers}", "request": TP_REQUEST[0],
        "decode_steps": TP_DECODE_STEPS, **row}), flush=True)
    totals.update(row["launches"])
    totals.update(row["unsharded"]["launches"])
    t0 = time.perf_counter()
    split = tp_shares(cfg, params, masks, batch, TP_RANKS, TP_DECODE_STEPS)
    totals.update(split["launches"])
    held = tp_held(cfg, params, masks, batch, split, TP_DECODE_STEPS)
    del params, masks, split
    torch.cuda.empty_cache()
    print("tensor_parallel " + json.dumps({
        "part": "d", "model": cfg.name, "layers": f"{layers} of "
        f"{full.num_layers}", "request": TP_REQUEST[0],
        "model_ranks": TP_RANKS, "decode_steps": TP_DECODE_STEPS, **held,
        "seconds": time.perf_counter() - t0}), flush=True)


def tp_wide(totals) -> None:
    """Phase 23 (e): the pruned Mixtral-8x7B, ``TP_WIDE`` layers, split
    over 16 "model" ranks run rank after rank: 2 heads and half an
    expert's columns a rank, its 8 KV heads on the head dim (the prefill's
    KV heads sent to the shards, the decode's queries sent to the cache);
    an R1 prefill and the decode steps held by ``tp_held``. A
    ``tensor_parallel`` line; its launches added to ``totals``."""
    import torch
    from repro_torch.configs import mixtral_8x7b
    layers, m, steps = TP_WIDE
    full = mixtral_8x7b.CONFIG
    cfg = full.replace(num_layers=layers)
    params, masks = model_setup(cfg, SEED)
    describe(cfg, params, masks, of_layers=full.num_layers,
             run="tensor parallel 16")
    (_, batch), = request_batches(cfg, [TP_REQUEST])
    t0 = time.perf_counter()
    split = tp_shares(cfg, params, masks, batch, m, steps)
    totals.update(split["launches"])
    held = tp_held(cfg, params, masks, batch, split, steps)
    del params, masks, split
    torch.cuda.empty_cache()
    print("tensor_parallel " + json.dumps({
        "part": "e", "model": cfg.name, "layers": f"{layers} of "
        f"{full.num_layers}", "request": TP_REQUEST[0], "model_ranks": m,
        "decode_steps": steps, **held,
        "seconds": time.perf_counter() - t0}), flush=True)


def tp_mamba(totals) -> None:
    """Phase 23 (f)-(h): the pruned Mamba2-2.7B at full width: (f)
    ``TP_MAMBA_LAYERS`` deep, an R1 request through the mesh steps on the
    one-rank NCCL mesh against the unsharded steps (``tp_one_rank``); (g)
    its ``TP_RANKS``-rank split rank after rank (40 SSD heads and 2,560
    gated-norm columns a rank), held by ``tp_held``; (h) ``TP_MAMBA_WIDE``
    layers on 16 ranks (5 heads, 320 columns, the gated norm through the
    split entries and ``ssd_scan`` at 5 heads). A ``tensor_parallel``
    line each; their launches added to ``totals``."""
    import torch
    from repro_torch.configs import mamba2_2p7b
    full = mamba2_2p7b.CONFIG
    for part, layers, m in (("f", TP_MAMBA_LAYERS, 1),
                            ("g", TP_MAMBA_LAYERS, TP_RANKS),
                            ("h",) + TP_MAMBA_WIDE):
        if part != "g":
            cfg = full.replace(num_layers=layers)
            params, masks = model_setup(cfg, SEED)
            describe(cfg, params, masks, of_layers=full.num_layers,
                     run=f"tensor parallel {part}")
            (_, batch), = request_batches(cfg, [TP_REQUEST])
        t0 = time.perf_counter()
        line = {"part": part, "model": cfg.name,
                "layers": f"{layers} of {full.num_layers}",
                "request": TP_REQUEST[0], "decode_steps": TP_DECODE_STEPS}
        if part == "f":
            row = tp_one_rank(cfg, params, masks, batch, TP_DECODE_STEPS,
                              part)
            totals.update(row["launches"])
            totals.update(row["unsharded"]["launches"])
        else:
            split = tp_shares(cfg, params, masks, batch, m,
                              TP_DECODE_STEPS)
            totals.update(split["launches"])
            row = tp_held(cfg, params, masks, batch, split,
                          TP_DECODE_STEPS)
            line["model_ranks"] = m
            del params, masks, split
            torch.cuda.empty_cache()
        print("tensor_parallel " + json.dumps({
            **line, **row, "seconds": time.perf_counter() - t0}),
            flush=True)


def tensor_parallel_phase() -> dict:
    """Phase 23: (a) the pruned Qwen2-7B at full width, ``TP_QWEN_LAYERS``
    deep, an R1 request through the mesh steps on the one-rank NCCL mesh,
    bit-equal to the unsharded steps (``tp_one_rank``); (b) its
    ``TP_RANKS``-rank
    split run rank after rank on the card (``tp_shares``), held to the LM
    phases' rule (``tp_held``); (c) and (d) the same for the pruned
    Mixtral-8x7B and DeepSeek-V3 (``tp_moe_run``); (e) Mixtral-8x7B at
    "model" = 16 (``tp_wide``); (f)-(h) Mamba2-2.7B (``tp_mamba``). One
    ``tensor_parallel`` line each and a ``phase23`` line. Returns the launches of the mesh runs and the
    splits, by kernel and route."""
    import torch
    from repro_torch.configs import qwen2_7b
    t0 = time.perf_counter()
    cfg = qwen2_7b.CONFIG.replace(num_layers=TP_QWEN_LAYERS)
    params, masks = model_setup(cfg, SEED)
    describe(cfg, params, masks, of_layers=qwen2_7b.CONFIG.num_layers,
             run="tensor parallel")
    (_, batch), = request_batches(cfg, [TP_REQUEST])
    row_a = tp_one_rank(cfg, params, masks, batch)
    print("tensor_parallel " + json.dumps({
        "part": "a", "model": cfg.name, "request": TP_REQUEST[0],
        "decode_steps": DECODE_STEPS, **row_a}), flush=True)
    total = collections.Counter(row_a["launches"])
    total.update(row_a["unsharded"]["launches"])
    t_b = time.perf_counter()
    split = tp_shares(cfg, params, masks, batch, TP_RANKS, TP_DECODE_STEPS)
    total.update(split["launches"])
    row_b = tp_held(cfg, params, masks, batch, split, TP_DECODE_STEPS)
    del params, masks, split
    torch.cuda.empty_cache()
    print("tensor_parallel " + json.dumps({
        "part": "b", "model": cfg.name, "request": TP_REQUEST[0],
        "model_ranks": TP_RANKS, "decode_steps": TP_DECODE_STEPS,
        **row_b}), flush=True)
    t_c = time.perf_counter()
    for module, layers in TP_MOE_RUNS:
        tp_moe_run(module, layers, total)
    t_e = time.perf_counter()
    tp_wide(total)
    t_f = time.perf_counter()
    tp_mamba(total)
    print("phase23 " + json.dumps({
        "seconds": time.perf_counter() - t0,
        "seconds_a": t_b - t0, "seconds_b": t_c - t_b,
        "seconds_cd": t_e - t_c, "seconds_e": t_f - t_e,
        "seconds_fh": time.perf_counter() - t_f,
        "launches": dict(total)}), flush=True)
    return dict(total)


#: phase 24: the data ranks of the sequence split, the decode steps, and
#: (registry module, layers kept, dense layers kept or None)
CP_RANKS = 2
CP_DECODE_STEPS = 4
CP_RUNS = (("qwen2_7b", 4, None), ("mamba2_2p7b", 4, None),
           ("deepseek_v3_671b", 2, 1))


def share_routes(cfg, calls, m: int):
    """One request's routes (``routes_of``'s form) from a sequence split's
    MoE calls (``watch_moe``): a prefill call's are the shares' blocks'
    routes joined in share order (B = 1: the request's token order), a
    decode step's the first share's (every share routes the same token).
    Empties ``calls``."""
    import torch
    from repro_torch.models.layers.moe import route
    shares = [[c for c in calls if c[6] == r] for r in range(m)]
    L = moe_layer_count(cfg)
    out = []
    for i, first in enumerate(shares[0]):
        made = [c[i] for c in shares] if i < L else [first]
        idx = [route(p, moe, x.reshape(-1, x.shape[-1]), mask)[1]
               for p, moe, x, mask, *_ in made]
        out.append((torch.cat(idx), float(first[4])))
    calls.clear()
    return out


def cp_shares(cfg, params, masks, batch, m: int, steps: int) -> dict:
    """Phase 24: the ``m``-share sequence split of ``cfg`` over "data" on
    the card, the shares run in turn (``SequentialRanks``,
    ``context_parallel.sequential_shares``): an R1 prefill (each share its
    block of the positions) and ``steps`` greedy decode steps (each share
    its block of the cache's slots). Returns ``tp_shares``' dict (every
    share's logits the same bits, launches ``m`` times one request's) with
    the device ms of a second run and the shares' layout."""
    import torch
    from repro_torch.data.requests import batch_shape
    from repro_torch.models import transformer as tr
    from repro_torch.sharding.context_parallel import sequential_shares
    from repro_torch.sharding.tensor_parallel import SequentialRanks
    B, S = batch_shape(cfg, batch)
    on_card = card_batch(cfg, batch)

    def request(record):
        ranks = SequentialRanks(m)
        pre, dec = sequential_shares(cfg, params, ranks, S + steps)

        def run(p, d):
            lg, cache = tr.prefill(params, cfg, on_card, max_len=S + steps,
                                   masks=masks, tp=p)
            out, fed = [lg.float()], []
            for _ in range(steps):
                nxt = lg.argmax(-1, keepdim=True)
                fed.append(nxt)
                lg, cache = tr.decode_step(params, cfg, cache, nxt,
                                           masks=masks, tp=d)
                out.append(lg.float())
            return out, torch.cat(fed, 1)
        with torch.no_grad(), (watch_moe() if record
                               else contextlib.nullcontext([])) as calls:
            res = ranks.run([lambda p=p, d=d: run(p, d)
                             for p, d in zip(pre, dec)])
        torch.cuda.synchronize()
        return res, calls
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, calls = request(True)
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    want = {k: m * v for k, v in expected_launches(cfg, steps).items()}
    if launches != want:
        raise AssertionError(f"phase 24 launches {launches}, expected "
                             f"{want}")
    for out, tok in res[1:]:
        if not (torch.equal(tok, res[0][1]) and all(
                torch.equal(a, b) for a, b in zip(out, res[0][0]))):
            raise AssertionError("phase 24: the shares' logits differ")
    routes = share_routes(cfg, calls, m)
    prof = device_profile(lambda: request(False))
    return {"logits": res[0][0], "tokens": res[0][1], "ms": ms,
            "device_ms": prof["device_ms"],
            "device_idle_share": prof["device_idle_share"],
            "routes": routes, "launches": launches,
            "shapes": [{"share": r, "positions": [r * S // m,
                                                  (r + 1) * S // m],
                        "q_offset": r * S // m,
                        "cache_slots": [r * (S + steps) // m,
                                        (r + 1) * (S + steps) // m]}
                       for r in range(m)]}


def context_parallel_phase() -> dict:
    """Phase 24: for each of ``CP_RUNS`` (the pruned config at full width,
    cut in depth, the MTP block released) a ``slice`` line and the
    ``CP_RANKS``-share sequence split of an R1 request (``cp_shares``),
    held by ``tp_held`` (every row within phase 6's rule of the unsharded
    bf16 and fp32 plain runs, teacher-forced with the split's tokens and
    routes); a ``context_parallel`` line each and a ``phase24`` line.
    Returns the launches, by kernel and route."""
    import importlib
    import torch
    t0 = time.perf_counter()
    total = collections.Counter()
    for module, layers, dense in CP_RUNS:
        t1 = time.perf_counter()
        full = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
        cfg = full.replace(num_layers=layers)
        if dense is not None:
            cfg = cfg.replace(num_dense_layers=dense)
        params, masks = model_setup(cfg, SEED)
        params.pop("mtp", None)
        describe(cfg, params, masks, of_layers=full.num_layers,
                 run="context parallel")
        (_, batch), = request_batches(cfg, [TP_REQUEST])
        split = cp_shares(cfg, params, masks, batch, CP_RANKS,
                          CP_DECODE_STEPS)
        total.update(split["launches"])
        held = tp_held(cfg, params, masks, batch, split, CP_DECODE_STEPS)
        device = {k: split[k] for k in ("device_ms", "device_idle_share")}
        del params, masks, split
        torch.cuda.empty_cache()
        print("context_parallel " + json.dumps({
            "model": cfg.name, "layers": f"{layers} of {full.num_layers}",
            "request": TP_REQUEST[0], "data_ranks": CP_RANKS,
            "decode_steps": CP_DECODE_STEPS, **held, **device,
            "seconds": time.perf_counter() - t1}), flush=True)
    print("phase24 " + json.dumps({"seconds": time.perf_counter() - t0,
                                   "launches": dict(total)}), flush=True)
    return dict(total)


# ---------------------------------------------------------------------------
# phase 25: the train step on a "data" = 2 sequence split
# ---------------------------------------------------------------------------
#: phase 25's runs: (registry module, layers kept, rows, tokens a row, how
#: the batch lies over "data"). DeepSeek-V3's is phase 20's T3: its first
#: (dense MLA) layer and the MTP block. A sequence split's one row of
#: 2,048 tokens is 1,024 positions a share; the rows split's 2 rows of
#: 1,024 one row a share
CP_TRAIN_RUNS = (("qwen2_7b", 4, 1, 2048, "sequence"),
                 ("mamba2_2p7b", 4, 1, 2048, "sequence"),
                 ("deepseek_v3_671b", 1, 1, 2048, "sequence"),
                 ("mixtral_8x7b", 2, 1, 2048, "sequence"),
                 ("mixtral_8x7b", 2, 2, 1024, "rows"))
#: phase 25's MoE run (DeepSeek-V3's layer 0 and MTP block are dense)
#: before the MoE dispatch's all-to-all, when a reduce-scatter of every
#: slot and an all-gather of the outputs crossed "data" (``p33a``, NVIDIA
#: H100 80GB HBM3, 700.00 W): share 0 / 1 wall and device ms
CP_TRAIN_SLOT_EXCHANGE_MS = {
    "mixtral-8x7b": {"wall_ms": [904.8, 903.0], "device_ms": [84.90, 92.43]}}


def cp_train_check(cfg, params, masks, batch, whole, parts) -> dict:
    """Phase 20's rule for phase 25's split (rank 0): the fp32 plain run
    of the unsharded step on a float32 copy (TF32 off), then the bf16
    plain run's and the unsharded kernel path's gaps to it, one gradient
    tree held at a time; each metric of ``whole`` (the shares' weighted
    metrics summed) and each leaf of the shares' gradients ``parts``
    summed in fp32 within twice the bf16 plain run's gap plus one bf16
    spacing (the relative L2 gap of a leaf), no leaf skipped (a leaf the
    loss never reads zero). Returns the line's fields."""
    import torch
    from repro_torch.device import exact_fp32
    from repro_torch.models import transformer as tr
    params32 = tr.cast_params(params, torch.float32)
    cfg32 = cfg.replace(dtype="float32")
    with exact_fp32():
        m32, g32 = train_grads(cfg32, params32, masks,
                               card_batch(cfg32, batch), "ref")
    del params32
    torch.cuda.empty_cache()
    g32 = dict(_named_leaves(g32))
    norms = {name: float(f.norm()) for name, f in g32.items()}

    def gaps(tree):
        """Each leaf's relative L2 gap to the fp32 run's (where that is
        zero: its largest entry)."""
        return {name: (float((g.float() - g32[name]).norm()) / norms[name]
                       if norms[name] else float(g.abs().max()))
                for name, g in tree}
    b = card_batch(cfg, batch)
    mp, gp = train_grads(cfg, params, masks, b, "ref")
    plain = gaps(_named_leaves(gp))
    del gp
    mk, gk = train_grads(cfg, params, masks, b, "auto")
    unsharded = gaps(_named_leaves(gk))
    del gk
    split = gaps((name, sum(t.float() for t in ts)) for name, *ts in zip(
        *([n for n, _ in _named_leaves(parts[0])],
          *[[t for _, t in _named_leaves(g)] for g in parts])))
    del g32
    torch.cuda.empty_cache()
    metrics, worst = {}, 0.0
    for k, f in m32.items():
        tol = 2 * abs(mp[k] - f) + BF16_SPACING * abs(f)
        gap = abs(whole[k] - f)
        metrics[k] = {"split": whole[k], "unsharded": mk[k],
                      "plain_bf16": mp[k], "fp32": f, "gap": gap,
                      "unsharded_gap": abs(mk[k] - f), "tol": tol}
        worst = max(worst, gap / tol if tol else float(gap > 0) * 1e9)
    leaves = {}
    for name, gap in split.items():
        if norms[name]:
            tol = 2 * plain[name] + BF16_SPACING
            ratio = gap / tol
        else:                   # a leaf the loss never reads: zero
            tol, ratio = 0.0, 0.0 if gap == 0.0 else float("inf")
        leaves[name] = {"gap": gap, "unsharded_gap": unsharded[name],
                        "plain_gap": plain[name], "tol": tol}
        worst = max(worst, ratio)
    row = {"metrics": metrics, "grad_gaps": leaves,
           "max_gap_over_tol": worst}
    if worst > 1.0:
        raise AssertionError(f"phase 25: {cfg.name}'s split off the "
                             f"unsharded step by {worst} of the tolerance: "
                             f"{json.dumps(row)}")
    return row


def cp_train_run(module: str, layers: int, rows: int, tokens: int,
                 split: str, axis, queue) -> dict | None:
    """One run of phase 25 on share ``axis.rank`` (both processes alike):
    ``module``'s config pruned at ratio 0.5 (``model_setup``, the same
    seeded weights in both), its depth cut to ``layers``, ``rows`` rows of
    ``tokens`` tokens; the share's loss and gradient
    (``launch.steps.share_loss_and_grads``: its block of the positions,
    or its row, as ``split`` says; the exchanges over ``axis``) profiled
    (``device_profile``), then once
    more with the launch counters zeroed just before and read just after
    (``expected_train_launches``: one unsharded step's) and the peak
    memory reset before it; the shares' weighted metrics all-reduced.
    Share 1 sends its gradient (the card's memory, through ``queue``),
    metrics and figures to share 0, which holds them to the unsharded step
    (``cp_train_check``) and returns the run's line (share 1: None)."""
    import importlib
    import torch
    import torch.distributed as dist
    from repro_torch.launch.steps import share_loss_and_grads
    full = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    cfg = full.replace(num_layers=layers)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, masks = model_setup(cfg, SEED)
    batch_np = train_batch(cfg, rows, tokens)
    batch = card_batch(cfg, batch_np)

    def step():
        out = share_loss_and_grads(cfg, params, batch, axis, masks,
                                   split=split)
        torch.cuda.synchronize()
        return out
    prof = device_profile(step)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metrics, grads, share = step()
    ms = 1e3 * (time.perf_counter() - t1)
    launches = read_launches()
    want = expected_train_launches(cfg)
    if launches != want:
        raise AssertionError(f"phase 25 share {axis.rank} launches "
                             f"{launches}, expected {want}")
    keys = sorted(metrics)
    whole = axis.all_reduce(torch.stack(
        [metrics[k].to(torch.float32) * share for k in keys])).cpu()
    if split == "rows":
        b = rows // axis.size
        part = {"rows": [axis.rank * b, (axis.rank + 1) * b]}
    else:
        L = tokens // axis.size
        part = {"positions": [axis.rank * L, (axis.rank + 1) * L],
                "q_offset": axis.rank * L}
    mine = {"share": axis.rank, **part, "share_of_labels": float(share),
            "loss": float(metrics["loss"]), "wall_ms": ms,
            "device_ms": prof["device_ms"],
            "device_idle_share": prof["device_idle_share"],
            "profiled_wall_ms": prof["wall_ms"], "by_kind": prof["by_kind"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}
    if axis.rank:
        queue.put({"grads": grads, "whole": whole, "share": mine})
        dist.barrier()                  # share 0 is done with the gradient
        return None
    other = queue.get()
    if not torch.equal(other["whole"], whole):
        raise AssertionError("phase 25: the shares' losses differ")
    check = cp_train_check(cfg, params, masks, batch_np,
                           dict(zip(keys, whole.tolist())),
                           [grads, other["grads"]])
    shares = [mine, other["share"]]
    del other, grads, params
    dist.barrier()
    torch.cuda.empty_cache()
    before = (CP_TRAIN_SLOT_EXCHANGE_MS.get(cfg.name)
              if (rows, tokens, split) == (1, 2048, "sequence") else None)
    if before is not None:
        before = {**before, "run": "p33a"}
    return {"model": cfg.name, "layers": f"{layers} of {full.num_layers}"
            + (" + mtp" if cfg.mtp_depth else ""), "batch": rows,
            "tokens": tokens, "split": split, "data_ranks": axis.size,
            "losses_same_bits": True, "shares": shares, **check,
            "slot_exchange_ms": before,
            "seconds": time.perf_counter() - t0}


def gloo_all_to_all_check(axis) -> dict:
    """Ragged bf16 rows of the card through gloo's ``all_to_all_single``
    (``tensor_parallel.all_to_all_rows``, what the MoE dispatch's
    exchange calls): rank r sends ``sizes[r][q]`` rows of 4,096 to rank
    q, zero-sized parts among them; each rank's rows arrive in rank order
    with their values, on the card. Returns the sizes."""
    import torch
    from repro_torch.sharding.tensor_parallel import all_to_all_rows
    sizes = [[3, 0], [5, 2]]
    me = axis.rank

    def rows(src, dst):
        return torch.full((sizes[src][dst], 4096), 10.0 * src + dst,
                          dtype=torch.bfloat16, device="cuda")
    got = all_to_all_rows([axis], torch.cat([rows(me, q) for q in range(
        axis.size)]), sizes)
    want = torch.cat([rows(r, me) for r in range(axis.size)])
    if got.device.type != "cuda" or not torch.equal(got, want):
        raise AssertionError(f"phase 25: gloo's all-to-all of card rows "
                             f"on rank {me} gave {got.shape} on "
                             f"{got.device}")
    return {"sizes": sizes, "dtype": "bfloat16", "device": "cuda",
            "delivered": True}


def cp_train_worker(rank: int, port: int, out_dir: str, queue) -> None:
    """One of phase 25's two processes on the card: a gloo group of both
    as the data seam (``tensor_parallel.GroupAxis``: gloo takes the card's
    tensors and stages them through host memory itself), then every run
    of ``CP_TRAIN_RUNS`` as its share; share 0 writes the runs' lines to
    ``out_dir``."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.sharding.tensor_parallel import GroupAxis
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=CP_RANKS,
                            timeout=datetime.timedelta(seconds=600))
    try:
        axis = GroupAxis(dist.group.WORLD, rank, CP_RANKS)
        ragged = gloo_all_to_all_check(axis)
        runs = [cp_train_run(*run, axis, queue) for run in CP_TRAIN_RUNS]
        if rank == 0:
            with open(os.path.join(out_dir, "phase25.json"), "w") as f:
                json.dump({"runs": runs, "gloo_all_to_all": ragged}, f)
    finally:
        dist.destroy_process_group()


def context_parallel_train_phase() -> dict:
    """Phase 25: the train step on a "data" = 2 sequence split, its two
    shares in two processes on the card (``cp_train_worker``: CUDA
    autograd runs every backward node of one process on one device
    thread, so two shares of one process would wait on each other there,
    and NCCL refuses two ranks on one card); a ``context_parallel_train``
    line each run and a ``phase25`` line. Returns the shares' launches,
    by kernel and route."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    queue = mp.get_context("spawn").SimpleQueue()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(cp_train_worker, args=(free_port(), d, queue),
                           nprocs=CP_RANKS, start_method="spawn")
        with open(os.path.join(d, "phase25.json")) as f:
            out = json.load(f)
    runs = out["runs"]
    total = collections.Counter()
    for run in runs:
        for share in run["shares"]:
            total.update(share["launches"])
        print("context_parallel_train " + json.dumps(run), flush=True)
    print("phase25 " + json.dumps({"seconds": time.perf_counter() - t0,
                                   "axis": "gloo, card tensors",
                                   "gloo_all_to_all": out["gloo_all_to_all"],
                                   "launches": dict(total)}), flush=True)
    return dict(total)


def kernel_entry(name, rows, main_rows, scale: int, launches: int,
                 **extra):
    """One kernel of the JSON line: times and bound summed over
    ``main_rows`` and multiplied by ``scale`` (how often one main-path
    request or prefill launches that shape), the worst error over all its
    checked ``rows``; ``library_ms`` null where no PyTorch call computes
    the function."""
    total = {k: scale * sum(r[k] for r in main_rows)
             for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    library = (None if any(r["library_ms"] is None for r in main_rows)
               else scale * sum(r["library_ms"] for r in main_rows))
    if all("device_ms" in r for r in main_rows):   # from a CUDA graph
        extra["device_ms"] = scale * sum(r["device_ms"] for r in main_rows)
    base = max((k for k in REPLACES if name.startswith(k)), key=len)
    return {"name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], **extra, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": ("bytes" if total["bytes_ms"] > total["ops_ms"]
                         else "operations"),
            "library_ms": library}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA "
              "card", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch import serving
    from repro_torch.kernels import build
    from repro_torch.models.cnn import (alexnet_config, compact_cnn_config,
                                        init_cnn_params)
    kernels_only = "--kernels-only" in sys.argv[1:]

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build {sorted(logs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "arning")):
                print(f"build {name}: {line.strip()}", flush=True)
    check_no_spills("flash_attention", logs["flash_attention"])
    check_no_spills("rmsnorm", logs["rmsnorm"])

    # 3. kernels against their plain versions
    cfg = alexnet_config(38)
    params = init_cnn_params(SEED, cfg)
    rng = np.random.default_rng(SEED + 1)
    masks = half_masks(cfg, params, rng)
    full = [(f"{n} full", M, K, N, "partial")
            for n, M, K, N in gemm_shapes(cfg)]
    compacted = [(f"{n} compact", M, K, N, "ones")
                 for n, M, K, N in gemm_shapes(compact_cnn_config(cfg, masks))]
    edge_cases = [("ragged", 77, 29, 45, "partial"),
                  ("m1", 1, 300, 50, "partial"),
                  ("all_zero_mask", 64, 128, 96, "zeros"),
                  ("partial_mask", 512, 256, 192, "partial")]
    rows = check_masked_matmul(full + compacted + edge_cases)
    # the compacted shapes from int8 codes, as the quantized edge runs them,
    # plus a ragged N (no vector copies) and a partial mask
    rows_q8 = check_masked_matmul_q8(
        full + compacted + [("q8 ragged", 77, 29, 45, "partial"),
                     ("q8 m1 ragged", 1, 300, 50, "partial"),
                     ("q8 partial_mask", 512, 256, 192, "partial")])
    # the float32 GEMV against the split-K tiles at dense14's compacted shape
    dense14 = next(r for r in rows if r["case"] == "dense14 compact")
    f32_gemv_splitk_crossover((1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
                              dense14["K"], dense14["N"])
    # Qwen2-7B: d_model 3584, d_ff 18944, 28 heads / 4 KV heads of 128
    d, dff = 3584, 18944
    # every route and its edges: the GEMV at 1 and 2 rows (and with K and N
    # off its block sizes), the wgmma tiles from 3 rows (3, 8, 9, 16, 64;
    # R2's ragged 2000, R1's 2048; K, N and M off the tile sizes), the
    # CUDA-core tiles for K or N not a multiple of 8; all-zero masks
    rows16 = check_masked_matmul(
        [("ffn prefill R1", 2048, d, dff, "half"),
         ("ffn prefill R2", 2000, d, dff, "half"),
         ("ffn decode R1", 1, d, dff, "half"),
         ("ffn decode R2", 2, d, dff, "half")]
        + [(f"ffn M={M}", M, d, dff, "half") for M in (3, 8, 9, 16, 64)]
        # DeepSeek-V3's dense layers: K = 7168, N = 18432
        + [("deepseek ffn prefill R1", 2048, 7168, 18432, "half"),
           ("deepseek ffn decode R1", 1, 7168, 18432, "half")]
        # DeepSeek-V3's R3 (8192 tokens) through its dense layers
        + [("deepseek ffn prefill R3", 8192, 7168, 18432, "half")]
        # Qwen2-VL-7B's R2: 2 x (1024 vision + 976 text) = 4000 rows
        + [("qwen2-vl ffn prefill R2", 4000, d, dff, "half")]
        # HuBERT-XLarge's non-gated FFN up product: K = 1280, N = 5120
        + [("hubert ffn prefill R1", 2048, 1280, 5120, "half"),
           ("hubert ffn prefill R2", 2000, 1280, 5120, "half")]
        # the shard shapes of tensor parallelism over "model": Qwen2-7B's
        # FFN columns on 2 ranks (d_ff / 2) and on 16 (d_ff / 16)
        + [(f"tp{m} ffn {mode} R1", M, d, dff // m, "half")
           for m in (2, 16) for mode, M in (("prefill", 2048),
                                            ("decode", 1))]
        + [("tiles ragged", 200, 3576, 1000, "partial"),
           ("gemv ragged", 2, 1000, 1000, "partial"),
           ("all_zero_mask tiles", 256, 512, 1024, "zeros"),
           ("all_zero_mask gemv", 2, 512, 1024, "zeros"),
           ("ragged", 77, 29, 45, "partial")], dtype="bfloat16")
    gemv_tiles_crossover((1, 2, 3, 4, 8, 16, 64), d, dff)
    launch_host_us(d, dff, dense14["K"], dense14["N"])
    norm_rows = check_rmsnorm(
        [(f"{r} rows {dt} +{off:g}", r, d, dt, off)
         for r in (2048, 2000, 1000) for dt in ("bfloat16", "float32")
         for off in (0.0, 1.0)]
        + [("decode rows 1 bfloat16 +0", 1, d, "bfloat16", 0.0),
           ("decode rows 2 bfloat16 +0", 2, d, "bfloat16", 0.0),
           ("ragged", 3, 77, "bfloat16", 1.0)]
        # Mamba2-2.7B (d_model 2560) and Zamba2-1.2B (2048): prefill and
        # decode rows of R1 and R2
        + [(f"{name} {r} rows bfloat16 +0", r, w, "bfloat16", 0.0)
           for name, w, rs in (("mamba2", 2560, (2048, 2000, 1, 2)),
                               ("zamba2", 2048, (2048, 1)),
                               ("mixtral", 4096, (2048, 8192, 1)),
                               # DeepSeek-V3: ln1/ln2 at d_model, MLA's
                               # q_norm and kv_norm at its two ranks
                               ("deepseek", 7168, (2048, 8192, 1)),
                               ("deepseek q_norm", 1536, (2048, 8192)),
                               ("deepseek kv_norm", 512, (2048, 8192)),
                               # Qwen2-VL-7B's R2: 4000 rows
                               ("qwen2-vl", d, (4000,)),
                               # HuBERT-XLarge: R1's and R2's frames
                               ("hubert", 1280, (2048, 2000)))
           for r in rs])
    # Mamba2-2.7B (d_inner 5120, projection 10576 wide) and Zamba2-1.2B
    # (4096 of 8384): z a slice of the projection, as the block hands it in
    gated_rows = check_gated_rmsnorm(
        [("mamba2 R1", 2048, 5120, 10576, 0, "bfloat16"),
         ("mamba2 R2", 2000, 5120, 10576, 0, "bfloat16"),
         ("mamba2 decode rows 1", 1, 5120, 10576, 0, "bfloat16"),
         ("mamba2 decode rows 2", 2, 5120, 10576, 0, "bfloat16"),
         ("zamba2 R1", 2048, 4096, 8384, 0, "bfloat16"),
         ("zamba2 decode rows 1", 1, 4096, 8384, 0, "bfloat16"),
         ("fp32", 1000, 5120, 10576, 0, "float32"),
         ("ragged", 33, 77, 77, 0, "bfloat16"),
         ("unaligned z", 300, 5120, 10576, 1, "bfloat16")])
    # the gated norm of a rank's d_inner columns under tensor parallelism
    # over "model": Mamba2-2.7B on 16 ranks (320 of 5,120, z in a 901-wide
    # projection: the scalar route) and on 2 (2,560 of 5,120 in 5,416)
    split_sums, split_stats = check_gated_split(
        [("mamba2 tp16 R1", 2048, 320, 901, "bfloat16", 5120),
         ("mamba2 tp16 decode rows 1", 1, 320, 901, "bfloat16", 5120),
         ("mamba2 tp2 R1", 2048, 2560, 5416, "bfloat16", 5120),
         ("aligned 320", 2048, 320, 640, "bfloat16", 5120),
         ("fp32", 1000, 320, 901, "float32", 5120),
         ("ragged", 33, 77, 77, "bfloat16", 200)])
    rmsnorm_plans([("qwen2 R1", 2048, d, False),
                   ("mamba2 R1", 2048, 2560, False),
                   ("zamba2 R1", 2048, 2048, False),
                   ("mamba2 gated R1", 2048, 5120, True),
                   ("zamba2 gated R1", 2048, 4096, True)])
    flash_rows = check_flash(
        [("prefill R1", 1, 2048, 28, 4, 128, True, None, "bfloat16"),
         ("prefill R2", 2, 1000, 28, 4, 128, True, None, "bfloat16"),
         ("window 512", 1, 2048, 28, 4, 128, True, 512, "bfloat16"),
         ("noncausal", 1, 1000, 28, 4, 128, False, None, "bfloat16"),
         ("window noncausal", 1, 300, 28, 4, 128, False, 40, "bfloat16"),
         ("fp32", 1, 512, 28, 4, 128, True, None, "float32"),
         ("head dim 64", 2, 300, 8, 2, 64, True, None, "bfloat16"),
         ("ragged 77", 1, 77, 28, 4, 128, True, None, "bfloat16"),
         ("zamba2 shared R1", 1, 2048, 32, 32, 64, True, None, "bfloat16"),
         # the large head dims: gemma-7b's R1 (16/16 heads of 256) and
         # nemotron-4-340b's heads (96/8 of 192), ragged and in fp32
         ("gemma-7b R1 D256", 1, 2048, 16, 16, 256, True, None, "bfloat16"),
         ("nemotron R1 D192", 1, 2048, 96, 8, 192, True, None, "bfloat16"),
         ("ragged 77 D256", 1, 77, 16, 16, 256, True, None, "bfloat16"),
         ("ragged 77 D192", 1, 77, 96, 8, 192, True, None, "bfloat16"),
         ("fp32 D256", 1, 512, 16, 16, 256, True, None, "float32"),
         ("fp32 D192", 1, 512, 96, 8, 192, True, None, "float32"),
         # Mixtral-8x7B's R1 and R3 (32/8 heads of 128, window 4096): at
         # 8192 tokens whole KV blocks fall behind the window and are
         # skipped
         ("mixtral R1", 1, 2048, 32, 8, 128, True, 4096, "bfloat16"),
         ("mixtral R3", 1, 8192, 32, 8, 128, True, 4096, "bfloat16"),
         # Qwen2-VL-7B's R2 (its R1 is Qwen2-7B's "prefill R1")
         ("qwen2-vl R2", 2, 2000, 28, 4, 128, True, None, "bfloat16"),
         # HuBERT-XLarge's R1 and R2 (16/16 heads of 80, non-causal), the
         # D = 80 instance ragged, in fp32, causal with GQA and windowed
         ("hubert R1 D80", 1, 2048, 16, 16, 80, False, None, "bfloat16"),
         ("hubert R2 D80", 2, 1000, 16, 16, 80, False, None, "bfloat16"),
         ("ragged 77 D80", 1, 77, 16, 16, 80, False, None, "bfloat16"),
         ("fp32 D80", 1, 512, 16, 16, 80, False, None, "float32"),
         ("causal D80", 1, 1000, 16, 4, 80, True, None, "bfloat16"),
         ("window D80", 1, 300, 16, 4, 80, True, 40, "bfloat16"),
         # a rank's heads under tensor parallelism over "model": Qwen2-7B
         # on 2 ranks (14 heads over 2 KV heads) and on 16 (2 over 1),
         # gemma-7b on 16 (1 over 1, D = 256)
         ("tp2 R1 14/2", 1, 2048, 14, 2, 128, True, None, "bfloat16"),
         ("tp16 R1 2/1", 1, 2048, 2, 1, 128, True, None, "bfloat16"),
         ("gemma tp16 R1 1/1 D256", 1, 2048, 1, 1, 256, True, None,
          "bfloat16"),
         # context parallelism over "data" = 2: the second share's block
         # of an R1 prefill (1,024 queries at q_offset 1,024) against the
         # keys of every position before it, Qwen2-7B's heads causal,
         # Mixtral-8x7B's (window 4,096), a window that cuts the keys; the
         # fp32 entry at an offset
         ("offset 1024 R1", 1, 2048, 28, 4, 128, True, None, "bfloat16",
          1024),
         ("offset 1024 mixtral", 1, 2048, 32, 8, 128, True, 4096,
          "bfloat16", 1024),
         ("offset 1024 window 512", 1, 2048, 28, 4, 128, True, 512,
          "bfloat16", 1024),
         ("offset 256 fp32", 1, 512, 28, 4, 128, True, None, "float32",
          256)])
    # Mamba2-2.7B: 80 heads of 64, d_state 128; Zamba2-1.2B: 64 heads of
    # 64, d_state 64; one B/C group each
    ssd_rows = check_ssd(
        [("mamba2 R1", 1, 2048, 80, 1, 64, 128, "bfloat16", "half"),
         ("mamba2 R2", 2, 1000, 80, 1, 64, 128, "bfloat16", "half"),
         ("zamba2 R1", 1, 2048, 64, 1, 64, 64, "bfloat16", "half"),
         ("groups 2", 1, 512, 8, 2, 64, 128, "bfloat16", "none"),
         ("short 77", 1, 77, 80, 1, 64, 128, "bfloat16", "half"),
         ("s1", 2, 1, 80, 1, 64, 128, "bfloat16", "half"),
         ("all pruned", 1, 300, 16, 1, 64, 64, "bfloat16", "zeros"),
         ("fp32", 1, 1000, 16, 1, 64, 128, "float32", "half"),
         ("fp32 d_state 64", 2, 300, 8, 2, 64, 64, "float32", "none"),
         # a rank's heads under tensor parallelism over "model":
         # Mamba2-2.7B's 80 heads on 16 ranks, 5 each
         ("mamba2 tp16 R1", 1, 2048, 5, 1, 64, 128, "bfloat16", "half")],
        profile_cases=("mamba2 R1", "zamba2 R1"))
    # the two Functions a Mamba2 block trains through, at the served R1
    # shapes of Mamba2-2.7B and Zamba2-1.2B
    check_ssd_grads([("mamba2 R1", 1, 2048, 80, 1, 64, 128),
                     ("zamba2 R1", 1, 2048, 64, 1, 64, 64)])
    check_gated_grads([("mamba2 R1", 2048, 5120, 10576),
                       ("zamba2 R1", 2048, 4096, 8384)])
    if kernels_only:
        print(smi, flush=True)
        return 0

    # 4. the AlexNet slice at full width
    images = [rng.standard_normal((1, 224, 224, 3), dtype=np.float32)
              for _ in range(REQUESTS)]
    n = len(cfg.layers)
    plans = {}
    for label, split, compact, bits in (("greedy", None, True, 8),
                                        ("c13", 13, True, 8),
                                        ("cN", n, True, 8),
                                        ("masked_cN", n, False, 8),
                                        ("cN_fp32", n, True, None)):
        plans[label] = serving.DeploymentPlan.from_args(
            params, cfg, split, masks=masks, compact=compact, codec="int8",
            quant=serving.QuantPolicy(weight_bits=bits))
    alex_routes, alex_rows = collections.Counter(), {}
    for label, plan in plans.items():
        alex_rows[label] = serve_path(label, plan, images,
                                      edge_gemm_count(plan))
        alex_routes.update(alex_rows[label]["routes"])

    # 5. where one full-width AlexNet request's device time goes
    profile_request(plans["greedy"], images[0])
    profile_request(plans["c13"], images[0])
    torch.cuda.empty_cache()

    # 6. the pruned Qwen2-7B at full width, served by prefill and decode
    from repro_torch.configs import (mamba2_2p7b, qwen2_7b, zamba2_1p2b)
    qcfg = qwen2_7b.CONFIG
    qparams, qmasks = model_setup(qcfg, SEED)
    describe(qcfg, qparams, qmasks)
    _, totals = transformer_slice(qcfg, qparams, qmasks, TRANSFORMER_REQUESTS)

    # 7. where one R1 prefill's and one decode step's device time goes
    profile_transformer(qcfg, qparams, qmasks)
    del qparams
    torch.cuda.empty_cache()

    # 8. the pruned Mamba2-2.7B at full width and depth
    mcfg = mamba2_2p7b.CONFIG
    mparams, mmasks = model_setup(mcfg, SEED)
    describe(mcfg, mparams, mmasks)
    _, mtotals = transformer_slice(mcfg, mparams, mmasks,
                                   TRANSFORMER_REQUESTS)

    # 9. the pruned Zamba2-1.2B (hybrid) at full width and depth
    zcfg = zamba2_1p2b.CONFIG
    zparams, zmasks = model_setup(zcfg, SEED)
    describe(zcfg, zparams, zmasks)
    _, ztotals = transformer_slice(zcfg, zparams, zmasks,
                                   TRANSFORMER_REQUESTS[:1])
    del zparams
    torch.cuda.empty_cache()

    # 10. where one Mamba2 R1 prefill's and one decode step's time goes
    profile_transformer(mcfg, mparams, mmasks)
    del mparams
    torch.cuda.empty_cache()
    for name in totals:
        totals[name] += mtotals[name] + ztotals[name]

    # 11. the socket deployment of the AlexNet plans, both peers on the card
    alex_routes.update(socket_phase(plans, images))

    # 12. the paper's pipeline at full AlexNet width, then its plan served
    alex_routes.update(pipeline_phase(images)["routes"])

    # 13. the streaming backend of the AlexNet plans
    alex_routes.update(streaming_phase(plans, images))

    # 14. calibration, energy and the adaptive split controller
    routes14, cal = adaptive_phase(plans, images, alex_rows)
    alex_routes.update(routes14)

    # 15. the device model, the roofline and the fleet simulator
    device_model_phase(smi)
    roofline_phase(plans["cN"], cal)
    fleet_phase()
    alex_routes.update(fleet_plan_phase(plans["c13"], images))

    # 16. the pruned Mixtral-8x7B at full width, 16 of its 32 layers
    xtotals = mixtral_phase()
    # 17. the pruned DeepSeek-V3 at full width, 5 of its 61 layers
    dtotals = deepseek_phase()
    # 18. the pruned Qwen2-VL-7B at full width and depth
    vtotals = qwen2_vl_phase()
    # 19. the pruned HuBERT-XLarge at full width and depth
    htotals = hubert_phase()
    # 20. training: pruned Qwen2-VL-7B, HuBERT-XLarge, DeepSeek-V3,
    # Mamba2-2.7B and Zamba2-1.2B through make_train_step
    ttotals, t2_launches = training_phase()
    # 21. the mesh and the example twins
    mtotals = mesh_phase()
    # 22. the pipelined split served on a one-pod mesh, and the dry run
    stotals = split_serve_phase()
    # 23. tensor parallelism over "model": the one-rank mesh and a
    # two-rank split's shares on the card
    ptotals = tensor_parallel_phase()
    # 24. context parallelism over "data": a two-share sequence split
    ctotals = context_parallel_phase()
    # 25. the train step on a two-share sequence split, two processes
    ktotals = context_parallel_train_phase()
    for name in totals:
        totals[name] += (xtotals[name] + dtotals[name] + vtotals[name]
                         + htotals[name] + ttotals[name] + mtotals[name]
                         + stotals[name] + ptotals[name] + ctotals[name]
                         + ktotals[name])
    alex_routes.update({k: v for k, v in mtotals.items()
                        if k.startswith(("masked_matmul_f32",
                                         "masked_matmul_q8"))})

    # times of the kernel line: each float32 / codes masked_matmul route
    # summed over the GEMMs of one c=N request of the compacted AlexNet plan
    # that take it (the convs on the split-K tiles, the dense layers on the
    # GEMV); the bf16 masked_matmul's GEMV over one Qwen2-7B R1
    # decode step (56 products); the other kernels over one R1 prefill of
    # the model that launches them most (Qwen2-7B: 56 FFN products on the
    # wgmma tiles, 57 norms, 28 attentions; Mamba2-2.7B: 64 scans, 64 gated
    # norms) at the prefill's shapes; the flash kernel's D = 80 instance
    # over one HuBERT-XLarge R1 prefill (48 attentions), with phase 19's
    # and phase 20's T2 launches; every launch count adds phase 20's train
    # steps
    from repro_torch.configs import hubert_xlarge
    L = qcfg.num_layers

    def case(rs, name):
        return [r for r in rs if r["case"] == name]
    def alex(rs, entry):
        mine = [r for r in rs if r["entry"] == entry]
        return mine, [r for r in mine if r["case"].endswith(" compact")]
    kernels = [
        kernel_entry(entry, *alex(rs, entry), 1, alex_routes[entry],
                     dtype=dtype)
        for rs, dtype in ((rows, "float32"), (rows_q8, "uint8 codes"))
        for entry in (f"masked_matmul_{'q8' if rs is rows_q8 else 'f32'}"
                      f"_{route}" for route in ("splitk", "gemv"))]
    kernels += [
        kernel_entry("masked_matmul_bf16_tiles",
                     [r for r in rows16
                      if r["entry"] == "masked_matmul_bf16_tiles"],
                     case(rows16, "ffn prefill R1"), 2 * L,
                     totals["masked_matmul_bf16_tiles"], dtype="bfloat16"),
        kernel_entry("masked_matmul_bf16_gemv",
                     [r for r in rows16
                      if r["entry"] == "masked_matmul_bf16_gemv"],
                     case(rows16, "ffn decode R1"), 2 * L,
                     totals["masked_matmul_bf16_gemv"], dtype="bfloat16"),
        kernel_entry("rmsnorm", norm_rows,
                     case(norm_rows, "2048 rows bfloat16 +0"), 2 * L + 1,
                     totals["rmsnorm"]),
        kernel_entry("rmsnorm_gated", gated_rows,
                     case(gated_rows, "mamba2 R1"), mcfg.num_layers,
                     totals["rmsnorm_gated"],
                     library=gated_rows[0]["library"]),
        kernel_entry("flash_attention", flash_rows,
                     case(flash_rows, "prefill R1"), L,
                     totals["flash_attention"],
                     offset_shape={k: case(flash_rows, "offset 1024 R1")[0][k]
                                   for k in ("q_offset", "ms", "device_ms",
                                             "plain_ms", "bound_ms",
                                             "library_ms")}),
        kernel_entry("flash_attention_d80",
                     [r for r in flash_rows if r["D"] == 80],
                     case(flash_rows, "hubert R1 D80"),
                     hubert_xlarge.CONFIG.num_layers,
                     htotals["flash_attention"]
                     + t2_launches["flash_attention"]),
        kernel_entry("rmsnorm_gated_sumsq", split_sums,
                     case(split_sums, "mamba2 tp16 R1 sumsq"),
                     mcfg.num_layers, totals["rmsnorm_gated_sumsq"]),
        kernel_entry("rmsnorm_gated_stat", split_stats,
                     case(split_stats, "mamba2 tp16 R1 stat"),
                     mcfg.num_layers, totals["rmsnorm_gated_stat"]),
        kernel_entry("ssd_scan", ssd_rows, case(ssd_rows, "mamba2 R1"),
                     mcfg.num_layers, totals["ssd_scan"],
                     passes=case(ssd_rows, "mamba2 R1")[0]["passes_ms"],
                     rank_shape={k: case(ssd_rows, "mamba2 tp16 R1")[0][k]
                                 for k in ("ms", "device_ms", "plain_ms",
                                           "bound_ms")})]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
