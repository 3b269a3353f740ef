"""Models: the causal linear-attention CP transformer."""
