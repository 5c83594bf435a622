"""Workload lowering for the port (job spec dicts -> ``[J, P]`` arrays)."""
