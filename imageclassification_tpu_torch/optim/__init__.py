"""Optimisers, schedules and the model EMA."""
