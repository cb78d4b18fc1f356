"""Metric meters and the TensorBoard sink."""
