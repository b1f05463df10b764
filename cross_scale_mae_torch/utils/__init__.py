"""The npz checkpoint format and the weight carry from the JAX package."""
