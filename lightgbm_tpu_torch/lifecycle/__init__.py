"""The serving lifecycle: of the JAX package's ``lifecycle/``, the traffic
recorder (``recorder.py``).  Shadow validation, the controller, the refit
budget and the autopilot are not ported: ROADMAP.md Queue A, "serving and
lifecycle"."""

from .recorder import TrafficRecorder

__all__ = ["TrafficRecorder"]
