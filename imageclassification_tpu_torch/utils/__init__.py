"""Metric helpers."""
