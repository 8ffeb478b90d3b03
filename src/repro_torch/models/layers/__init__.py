"""Transformer layers: norms, rotary embeddings, GQA and MLA attention,
the feed-forward block, the MoE layer and the Mamba2 (SSD) block (the
reference's ``models/layers``), and ``init``, the weight draw they
share."""
