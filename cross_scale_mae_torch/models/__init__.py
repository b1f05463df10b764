"""The encoder and its transformer blocks, on dicts of tensors."""
