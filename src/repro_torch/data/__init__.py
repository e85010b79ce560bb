"""Synthetic corpus generation (host-side numpy)."""
