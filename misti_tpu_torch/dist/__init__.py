"""Replicate sharding across processes (torch.distributed)."""
