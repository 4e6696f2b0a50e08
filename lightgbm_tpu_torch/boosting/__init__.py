"""Boosting loops of the port (the synchronous GBDT loop)."""
