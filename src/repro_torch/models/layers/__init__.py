"""Transformer layers: norms, rotary embeddings, GQA attention and the
feed-forward block (the reference's ``models/layers``, dense half)."""
