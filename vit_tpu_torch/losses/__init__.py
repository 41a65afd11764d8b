"""Perceptual loss and its antialiased resize."""
