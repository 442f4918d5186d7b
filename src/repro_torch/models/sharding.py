"""Logical sharding annotations, on one card.

The JAX package annotates activations with logical axes that a mesh
context maps onto physical mesh axes.  The port runs on one card, where
every annotation is the identity: :func:`shard` returns its input, and
the axis names are kept so the model code reads like the reference.
Meshes come with ROADMAP queue 1, item 6.
"""
from __future__ import annotations

BATCH = "batch"
MODEL = "model"


def shard(x, *logical):
    """The identity (one card, no mesh)."""
    return x
