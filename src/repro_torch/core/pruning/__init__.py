"""Structured pruning: the masks (the pruner's actuator), the AMC
environment, the DDPG agent and the policy search (paper §3.2)."""
