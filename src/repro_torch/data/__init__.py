"""The deterministic synthetic token stream."""
