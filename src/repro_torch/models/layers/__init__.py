"""Transformer layers: norms, rotary embeddings, GQA attention, the
feed-forward block and the Mamba2 (SSD) block (the reference's
``models/layers``, without MoE and MLA)."""
