"""Continuous-batching serving over the tier-aware paged KV cache."""
