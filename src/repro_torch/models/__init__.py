"""The LM substrate's dense decoders: layers, model assembly, the public
model API and the weight carry from the JAX package's parameters."""
