"""LM training: AdamW with global-norm clipping, the train step (remat and
gradient accumulation) and manifest-based checkpoints in the reference's
layout."""
