"""ViT backbone and the TiTok tokenizer."""
