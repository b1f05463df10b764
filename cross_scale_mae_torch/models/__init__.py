"""The MAE model (encoder, decoder, predictors, losses) on dicts of tensors."""
