"""Sampler kernels: the Newton-MH update, the sweep and the carry."""
