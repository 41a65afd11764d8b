"""Optimizer, train state and train step."""
