"""Average model parameters over multiple checkpoints.

Counterpart of ``espresso_tpu/cli/average_checkpoints.py`` (the reference's
scripts/average_checkpoints.py): the ``params`` trees of N port checkpoints
(``train/checkpoint.py``), averaged leaf by leaf (float64 sums in the given
order, float32 result), written as a new checkpoint directory whose other
arrays are the first checkpoint's and whose ``host_state.json`` is the
last one's. Host code: no device is used.

Usage:
    python -m espresso_tpu_torch.cli.average_checkpoints \\
        --inputs ckpt/checkpoint28 ckpt/checkpoint29 ckpt/checkpoint30 \\
        --output ckpt/checkpoint_avg
    # or: --inputs ckpt --num-epoch-checkpoints 5  (the last 5 epoch checkpoints)
"""

from __future__ import annotations

import argparse
import logging
import os
import re

from espresso_tpu_torch.cli.logging_utils import setup_logging
from espresso_tpu_torch.train.checkpoint import (
    flatten_tree,
    average_trees,
    load_checkpoint_state,
    save_checkpoint_state,
)

logger = logging.getLogger("espresso_tpu_torch.average_checkpoints")


def main(argv=None):
    setup_logging()
    p = argparse.ArgumentParser()
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--num-epoch-checkpoints", type=int, default=None)
    args = p.parse_args(argv)

    paths = args.inputs
    if args.num_epoch_checkpoints is not None:
        if len(paths) != 1:
            p.error("--num-epoch-checkpoints expects one directory")
        root = paths[0]
        epochs = sorted(
            int(m.group(1))
            for name in os.listdir(root)
            if (m := re.fullmatch(r"checkpoint(\d+)", name))
        )
        paths = [os.path.join(root, f"checkpoint{e}") for e in epochs[-args.num_epoch_checkpoints :]]
    logger.info("averaging %d checkpoints: %s", len(paths), paths)

    trees, host_state = [], {}
    for path in paths:
        tree, host_state = load_checkpoint_state(path)
        trees.append(tree)
    template = dict(trees[0])
    template["params"] = average_trees([t["params"] for t in trees])
    save_checkpoint_state(os.path.abspath(args.output), flatten_tree(template), host_state)
    logger.info("wrote averaged checkpoint to %s", args.output)


if __name__ == "__main__":
    main()
