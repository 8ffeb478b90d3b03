"""NVIDIA H100 SXM device model: the peaks of NVIDIA's data sheet for the
80 GB SXM part, dense rates (no sparsity) at the 700 W power limit. A card
set to a lower ``power.limit`` runs slower under load; every measurement
this model is held against names the card's limit beside it.

The names the JAX package's TPU model uses are kept where their meaning
carries (``PEAK_FLOPS_BF16``, ``HBM_BW``, ``HBM_BYTES``); the collective
rate is NVLink's.
"""

#: dense bf16 (and fp16) tensor-core rate, FLOP/s
PEAK_FLOPS_BF16 = 989e12
#: fp32 on the CUDA cores (outside the tensor cores), FLOP/s
PEAK_FLOPS_FP32 = 67e12
#: dense int8 tensor-core rate, OP/s
PEAK_OPS_INT8 = 1979e12
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: HBM3 capacity: five 16 GiB stacks (the driver shows a little less)
HBM_BYTES = 80 * 1024 ** 3
#: L2 cache: 50 MB (the 51,200 KiB of the data sheet)
L2_BYTES = 50 * 2 ** 20
#: streaming multiprocessors of the SXM part
SM_COUNT = 132
#: NVLink 4: 18 links, 900 GB/s in total, 450 GB/s each way
NVLINK_BW = 900e9
#: the collective term divides by one direction's rate: a card's share of
#: a collective is the bytes it sends, and they leave over the outgoing
#: half of its links while the incoming half carries what it receives
NVLINK_BW_PER_DIRECTION = NVLINK_BW / 2
#: a DGX H100 node's compute fabric, bytes/s: its data sheet's eight
#: single-port ConnectX-7 cards, one a GPU, at 400 Gb/s (InfiniBand NDR)
#: each, 3.2 Tb/s in all
NODE_FABRIC_BW = 3.2e12 / 8
#: cards of a DGX H100 node, joined all to all by NVLink
CARDS_PER_NODE = 8
#: a card's share of its node's fabric, bytes/s: what a collective group
#: that spans nodes moves a card
NODE_FABRIC_BW_PER_CARD = NODE_FABRIC_BW / CARDS_PER_NODE

#: the dry run's meshes: one (16, 16) ("data", "model") mesh of 32 nodes,
#: and two of them as ("pod", "data", "model") (2, 16, 16)
SINGLE_MESH_CARDS = 256
MULTI_MESH_CARDS = 512
