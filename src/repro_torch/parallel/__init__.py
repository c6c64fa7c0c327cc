"""Sharding of the port: logical-axis activation constraints (``sharding``)."""
