"""Column-masked GEMM: ``(A @ B) * col_mask`` — the edge's conv (im2col)
and dense layers. ``ops.masked_matmul`` is the wrapper (CUDA kernel on a
card, ``ref.masked_matmul_ref`` on the CPU)."""
