"""Histogram, packing and split-search operators of the port."""
