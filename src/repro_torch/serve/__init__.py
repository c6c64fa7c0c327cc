"""Serving: prefill and decode steps and the batched ``Engine``."""
