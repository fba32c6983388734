"""End-to-end example of the PyTorch port: train a small LM for a few hundred
steps under the straggler-aware runtime (speculative gradient-shard
replication, online policy adaptation, failures, checkpoints).

    PYTHONPATH=src python examples/torch_straggler_training.py                 # on the card
    PYTHONPATH=src python examples/torch_straggler_training.py --device cpu

This is a thin preset over ``repro_torch.launch.train`` (the port's
counterpart of ``examples/straggler_training.py``); see that module for
the full CLI.  Arguments given here are passed through and override the
preset.
"""

import os
import sys
import tempfile

from repro_torch.launch.train import main

if __name__ == "__main__":
    main(
        [
            "--arch", "qwen2-0.5b",
            "--steps", "200",
            "--batch", "8",
            "--seq", "128",
            "--n-tasks", "8",
            "--dist", "pareto",
            "--checkpoint-dir", os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
            "--log-every", "20",
        ]
        + sys.argv[1:]
    )
