"""Parameter initialisers."""
