"""The LM substrate's models (dense, MoE, the RG-LRU/local hybrid, RWKV6,
the Whisper encoder-decoder): layers, the MoE FFN, the RG-LRU block, the
RWKV6 time and channel mix, model assembly, the public model API and the
weight carry from the JAX package's parameters."""
