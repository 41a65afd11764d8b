"""Tokenizer export and the npy-over-HTTP server."""
