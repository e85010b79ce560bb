"""Synthetic corpus generation and the LM token stream (host-side numpy)."""
