"""The GPU stack's launcher form: ``python -m deep_neuroevolution_torch.train
cfg.json [train options]`` (gpu_implementation/es.py:290-293, ga.py:275-277;
the JAX package's train.py). It runs ``main train`` on the file with
``--log_dir logs`` (resuming from ``logs/snapshot.pkl``) and
``--iterations 0`` (until stopped), unless the options given after the file
say otherwise, e.g. ``--device cpu`` or ``--overrides '{...}'``."""

import sys

from .main import main

if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python -m deep_neuroevolution_torch.train cfg.json [train options]")
    sys.exit(main(["train", "--exp_file", sys.argv[1], "--log_dir", "logs", "--iterations", "0", *sys.argv[2:]]))
