"""The model stack on PyTorch: the ``attn`` and ``moe`` block kinds of the
JAX package's transformer (GQA, sliding-window attention, capacity-based
MoE dispatch), enough to serve and train the dense and MoE architectures;
the other block kinds raise ``NotImplementedError``."""
