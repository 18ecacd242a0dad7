"""CloudLM in PyTorch: layers, the transformer and generation."""
