"""The LM substrate's decoders (dense, MoE, the RG-LRU/local hybrid):
layers, the MoE FFN, the RG-LRU block, model assembly, the public model
API and the weight carry from the JAX package's parameters."""
