"""The LM zoo, the dense family: primitive layers, GQA attention and the
KV cache, the layer stacks and the top-level model."""
