"""Quickstart on the PyTorch/CUDA port: build a CXL system, enumerate it,
online the expander, and characterize DRAM vs CXL with STREAM — the same
calls as ``examples/quickstart.py``, through ``repro_torch``.  Each suite
below is ONE batched device call (the MESI kernel on the card).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

It runs on the CUDA card unless ``--device`` names another device; with
no card and no ``--device cpu`` it raises.
"""
import argparse

from repro_torch.core import CXLRAMSim, SimConfig
from repro_torch.core import cache as cache_mod
from repro_torch.core import numa


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # a host with 16 GiB DRAM and one 16 GiB CXL expander card on the I/O
    # bus
    sim = CXLRAMSim(SimConfig(
        dram_gib=16, expander_gib=(16,),
        cache=cache_mod.CacheParams(l1_bytes=16 * 1024,
                                    l2_bytes=128 * 1024)),
        device=args.device)

    # CXL-CLI flow: list memdevs (mailbox IDENTIFY), online as a zNUMA node
    print("memdevs:", sim.memdevs())
    print("regions:", sim.online(mode="znuma"))
    print("numastat:", sim.numastat())

    # the calibration surface the paper exposes (§III-B.2)
    print("\nCXL path latency breakdown (ns):")
    for stage, ns in sim.latency_breakdown().items():
        print(f"  {stage:>26}: {ns:.1f}")

    # §IV: STREAM triad at k x L2 on the zNUMA node — all footprints
    # batched into one kernel call by CXLRAMSim.stream_suite
    print("\nSTREAM triad bound to CXL (one device program):")
    for r in sim.stream_suite(footprint_factors=(2, 4, 8)):
        print(f"  {r['footprint_x_l2']}x L2: {r['bw_total_gbps']:.2f} GB/s, "
              f"LLC miss {r['l2_miss_rate']:.1%}, "
              f"loaded CXL latency {r['lat_cxl_ns']:.0f} ns")

    # placement policies at a fixed 4x L2 footprint — again one batched
    # sweep
    print("\npage placement at 4x L2 (one device program):")
    for r in sim.sweep(footprint_factors=(4,),
                       policies=[numa.ZNuma(0.0),
                                 numa.WeightedInterleave(1, 1),
                                 numa.ZNuma(1.0)]):
        print(f"  {r['policy']:>18}: {r['bw_total_gbps']:.2f} GB/s "
              f"(dram {r['bw_dram_gbps']:.2f} / cxl {r['bw_cxl_gbps']:.2f})")


if __name__ == "__main__":
    main()
