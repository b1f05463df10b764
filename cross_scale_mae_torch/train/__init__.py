"""The pretrain step: learning-rate schedule, AdamW, train state and step builder."""
