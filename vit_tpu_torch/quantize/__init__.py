"""Vector quantizers."""
