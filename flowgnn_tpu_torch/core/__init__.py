"""Numpy host layer: graph containers, packing, synthetic data, layouts."""
