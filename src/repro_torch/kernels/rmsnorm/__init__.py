"""Row-wise RMSNorm: ``x * rsqrt(mean(x²) + eps) * (scale + scale_offset)``
— every pre-norm of the transformer stack. ``ops.rmsnorm`` is the wrapper
(CUDA kernel on a card, ``ref.rmsnorm_ref`` on the CPU)."""
