"""Column-masked GEMM: ``(A @ B) * col_mask`` — the edge's conv (im2col)
and dense layers, and the pruned transformer's FFN products.
``ops.masked_matmul`` is the wrapper, ``ops.masked_matmul_q8`` the same with
B as uint8 codes (CUDA kernels on a card, ``ref.masked_matmul_ref`` on the
CPU)."""
