"""The model stack on PyTorch: the ``attn`` block kind of the JAX package's
transformer (GQA, sliding-window attention), enough to serve the dense
architectures; the other block kinds raise ``NotImplementedError``."""
