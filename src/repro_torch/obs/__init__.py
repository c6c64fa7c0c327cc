"""Observability for the port.  Ported so far: ``clock``, the one clock
domain every stamp is taken in."""
