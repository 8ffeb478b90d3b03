"""``repro_torch`` — the PyTorch/CUDA port of ``repro``, slice by slice.

It serves the paper's split AlexNet on one NVIDIA Hopper card: the
deployment contract (``serving.DeploymentPlan``), the local backend
(``serving.connect(plan, backend="local")``), the quantized edge whose
conv (im2col) and dense layers run through the hand-written CUDA
``masked_matmul`` kernel (``kernels/masked_matmul``, source in
``csrc/masked_matmul.cu``), and the fp32 cloud half on PyTorch's conv and
GEMM ops. It imports ``torch`` and ``numpy`` and nothing of the JAX
package: plans, parameters and wire frames cross between the two through
files and bytes (``interop``), and the tests hold the port against the
reference on shared inputs.

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``); on a CPU tensor every kernel wrapper runs
its plain PyTorch version.
"""
