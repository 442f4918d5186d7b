"""The model stack on PyTorch: every block kind of the JAX package's
transformer — ``attn`` (GQA, sliding-window or MLA attention), ``moe``
(capacity-based dispatch), ``rwkv`` (RWKV6 time- and channel-mix) and
``rec`` (Griffin's RG-LRU) — enough to serve and train every
architecture in ``configs/``."""
