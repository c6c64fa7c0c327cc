"""Socket transport for multi-host fleets.

``framing`` is the wire layer (magic/version handshake, length-prefixed
pickle frames, loud typed failures); ``remote`` is the coordinator side
(``RemoteFleet`` — the transport-agnostic fleet scheduler over framed TCP
peers); ``repro_torch.fleet.agent`` is the host side (``python -m
repro_torch.fleet.agent`` joins a machine's worker processes to a
coordinator).  The frame bytes are the JAX package's; the pickles inside
name the port's classes, so a port coordinator serves port agents only.
"""
from repro_torch.fleet.transport.framing import (  # noqa: F401
    MAGIC, VERSION, FramingError, TransportClosed, TransportError,
    VersionMismatch)
from repro_torch.fleet.transport.remote import (  # noqa: F401
    AgentPeer, RemoteFleet, parse_addr, run_remote_fleet)
