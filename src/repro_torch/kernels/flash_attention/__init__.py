"""Flash attention: online-softmax attention with causal and sliding-window
masks and grouped KV heads — the prefill attention of the transformer
stack. ``ops.flash_attention`` is the wrapper (CUDA kernel on a card,
``ref.attention_ref`` on the CPU)."""
