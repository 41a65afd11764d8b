"""Attention and GELU ops."""
