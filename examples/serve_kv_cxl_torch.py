"""Tier-aware serving demo on the PyTorch/CUDA port: batched requests
decode over a paged KV cache whose pages spill to the (simulated,
calibrated) CXL pool — the same run as ``examples/serve_kv_cxl.py``,
through ``repro_torch.launch.serve`` (one paged-attention kernel launch
per decode step on the card).

    PYTHONPATH=src python examples/serve_kv_cxl_torch.py [--device cpu]

Further arguments go to ``repro_torch.launch.serve``; it serves on the
CUDA card unless ``--device`` names another device.
"""
import sys

from repro_torch.launch import serve


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    sys.argv = ["serve", "--requests", "6", "--prefill", "48",
                "--decode", "12", "--page-size", "8",
                "--hbm-pages", "18"] + argv
    serve.main()


if __name__ == "__main__":
    main()
