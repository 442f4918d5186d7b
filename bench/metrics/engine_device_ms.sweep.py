"""Device time per sweep outside the MESI kernels' entry ranges (K1/K2 in
``bench.k1``, K3 in ``bench.k3``): trace build on the device, tier routing,
padding and stacking, the stats' copy back (``core/engine.py`` and what it
calls around the kernels)."""


def read(ctx):
    s, c = ctx["summary"], ctx["counters"]
    if s is None or not c.get("traced_sweeps") or not s.ops:
        return None
    return s.device_us(outside=("bench.k1", "bench.k3")) \
        / c["traced_sweeps"] / 1e3
