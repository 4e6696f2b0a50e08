"""Boosting loops of the port: GBDT (synchronous or pipelined) and its
variants GOSS, DART and random forest, built through ``create_boosting``
(`src/boosting/boosting.cpp:30-63`, JAX ``boosting/__init__.py``)."""

from typing import Optional

from .dart import DART
from .gbdt import GBDT
from .goss import GOSS
from .rf import RF

BOOSTING = {"gbdt": GBDT, "gbrt": GBDT, "dart": DART, "goss": GOSS,
            "rf": RF, "random_forest": RF}


def create_boosting(cfg, device, boosting: Optional[str] = None) -> GBDT:
    """The boosting object of ``boosting`` (default ``cfg.boosting``) on
    ``device``; an unknown name raises ``ValueError`` as the JAX factory
    does."""
    name = cfg.boosting if boosting is None else boosting
    if name not in BOOSTING:
        raise ValueError(f"Unknown boosting type {name}")
    return BOOSTING[name](cfg, device)
