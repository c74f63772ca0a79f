"""Volume-driven training of the V2 family (larvanet_tpu/cli/train_larvaV2.py;
reference train_larvaV2.py):

    python -m larvanet_tpu_torch.cli.train_larvaV2 --train_path runs/v2 [flags of
        train_larva] [--steps_per_epoch N]

train_larva with LarvaNetV2 as the default model and `steps_per_epoch`
set on the model the moment the registry makes it: an epoch is 300 MiB
of input pixels (patch^2 * batch * 3 bytes a step), rounded to one
significant figure, unless --steps_per_epoch gives it (reference
train_larvaV2.py:74-81). The flag is taken out before the hand-off.
Returns what train_larva's `main` returns; its flags are train_larva's,
--qat 1 among them.
"""

from __future__ import annotations

import argparse
import math
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", type=str, default="LarvaNetV2")
    pre.add_argument("--steps_per_epoch", type=float, default=None)
    pre.add_argument("--batch_size", type=int, default=16)
    pre.add_argument("--input_patch_size", type=int, default=48)
    known, _ = pre.parse_known_args(argv)

    if known.steps_per_epoch is None:
        batch_data_size = (known.input_patch_size ** 2) * known.batch_size * 3
        spe = 300 * (1024 ** 2) / batch_data_size
        spe = round(spe, -int(math.floor(math.log10(abs(spe)))))
    else:
        spe = known.steps_per_epoch
    print("%s steps equal to 1 epoch" % (spe,))

    if "--model" not in argv:
        argv = ["--model", known.model] + argv
    if "--steps_per_epoch" in argv:
        i = argv.index("--steps_per_epoch")
        del argv[i:i + 2]

    from larvanet_tpu_torch.cli import train_larva
    from larvanet_tpu_torch.core import registry

    # steps_per_epoch goes on the model the moment it is made
    orig_get_model = registry.get_model

    def patched(name):
        model = orig_get_model(name)
        model.steps_per_epoch = int(spe)
        return model

    registry.get_model = patched
    try:
        return train_larva.main(argv)
    finally:
        registry.get_model = orig_get_model


if __name__ == "__main__":
    main()
