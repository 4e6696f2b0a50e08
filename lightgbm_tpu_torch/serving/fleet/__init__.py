"""Serving fleet: binary wire protocol, async gateway, replica dispatch.

``FleetServer`` is the production front end (`gateway.py`): a selector
event loop speaking the binary wire protocol (`wire.py`), the pickle
framing and a Prometheus ``GET /metrics`` on one port, dispatching
least-loaded across ``Replica`` stacks (`replicas.py`), several per card
where asked, with per-replica health ejection and zero-drop rolling
promotion."""

from .gateway import FleetServer
from .replicas import Replica, ReplicaSet
from .wire import (WIRE_VERSION, WireError, recv_wire_frame,
                   send_wire_frame)

__all__ = ["FleetServer", "Replica", "ReplicaSet", "WIRE_VERSION",
           "WireError", "recv_wire_frame", "send_wire_frame"]
