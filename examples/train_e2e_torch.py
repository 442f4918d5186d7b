"""End-to-end training driver on the PyTorch/CUDA port: a granite-family
model trained for a few hundred steps on the synthetic pipeline, with
checkpointing and a mid-run injected host failure (restart + replay, loss
continuous) — the same run as ``examples/train_e2e.py``, through
``repro_torch.launch.train``.

Default is a ~20M-param model; pass ``--hundred-m`` for the ~100M
configuration (same code path, longer run).  Checkpoints go under the
temporary directory unless ``--ckpt-dir`` says otherwise.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 200] [--hundred-m] [--device cpu]

It trains on the CUDA card unless ``--device`` names another device.
"""
import os
import sys
import tempfile

from repro_torch.launch import train


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    hundred = "--hundred-m" in argv
    argv = [a for a in argv if a != "--hundred-m"]
    if hundred:
        dims = ["--layers", "12", "--d-model", "768", "--d-ff", "2688",
                "--vocab", "4096"]
    else:
        dims = ["--layers", "6", "--d-model", "384", "--d-ff", "1344",
                "--vocab", "2048"]
    sys.argv = (["train"] + dims +
                ["--arch", "granite-3-8b", "--steps", "200",
                 "--batch", "4", "--seq", "128",
                 "--ckpt-every", "50", "--fail-at", "120",
                 "--ckpt-dir",
                 os.path.join(tempfile.gettempdir(), "repro_e2e_ckpt")]
                + argv)
    train.main()


if __name__ == "__main__":
    main()
