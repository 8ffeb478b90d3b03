"""Chunked SSD (Mamba2 state-space duality) scan with the pruning head-mask
epilogue — the sequence mixer of the Mamba2 block. ``ops.ssd_scan`` is the
wrapper (CUDA kernel on a card, ``ref.ssd_scan_ref`` on the CPU)."""
