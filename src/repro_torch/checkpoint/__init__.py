"""Atomic, async checkpoints that both packages read."""
