"""ViT backbone, the TiTok tokenizer and the VideoGPT AR prior."""
