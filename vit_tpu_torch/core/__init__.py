"""Transformer configuration and the pre-LN transformer core."""
