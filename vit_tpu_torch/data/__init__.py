"""Data loaders of the port (numpy, host side)."""
