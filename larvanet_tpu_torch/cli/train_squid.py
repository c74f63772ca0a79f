"""train_squid (larvanet_tpu/cli/train_squid.py; reference train_squid.py):
the volume-driven loop of cli/train_larva.py calling the model's
`train_step_squid`.

No model of the zoo defines `train_step_squid`, in the reference, the JAX
package or the port, so the reference crashes with an AttributeError on its
first step. This CLI raises the JAX package's AttributeError before any
step instead; a model that defines `train_step_squid` trains through
train_larva's loop with it. Flags are train_larva's.
"""

from __future__ import annotations

import sys

from larvanet_tpu_torch.cli import train_larva
from larvanet_tpu_torch.core import registry


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args, _ = train_larva.build_parser().parse_known_args(argv)
    if not hasattr(registry.get_model(args.model), "train_step_squid"):
        raise AttributeError(
            "model %r does not define train_step_squid (this CLI is dead "
            "code in the reference too — no model implements it)" % (args.model,))
    return train_larva.main(argv, step="train_step_squid")


if __name__ == "__main__":
    main()
