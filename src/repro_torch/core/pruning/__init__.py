"""Structured pruning masks (the pruner's actuator); the DDPG search comes
with the paper-pipeline slice."""
