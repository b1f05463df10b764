"""The npz checkpoint format, the weight carry to and from the JAX package, FLOP counts."""
