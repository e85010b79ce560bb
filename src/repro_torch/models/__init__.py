"""The LM substrate's models (dense, MoE, the RG-LRU/local hybrid, RWKV6,
the Whisper encoder-decoder): layers, the MoE FFN, the RG-LRU block, the
RWKV6 time and channel mix, model assembly (with per-group remat), the
public model API (with the training loss) and the weight carry to and
from the JAX package's parameters."""
