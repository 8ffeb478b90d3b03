"""Sharding specs and activation constraints on ``torch.distributed``'s
``DeviceMesh`` and DTensor placements (the JAX package's ``sharding``)."""
