"""The serving fleet's binary wire protocol (``wire.py``).  The fleet
itself (the async gateway and the replica set) is not ported: ROADMAP.md
Queue A, "serving and lifecycle"."""

from .wire import (WIRE_VERSION, WireError, recv_wire_frame,
                   send_wire_frame)

__all__ = ["WIRE_VERSION", "WireError", "recv_wire_frame",
           "send_wire_frame"]
