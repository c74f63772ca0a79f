"""TreeNet's weight-space experiment (larvanet_tpu/cli/state_dict_tree.py;
reference state_dict_tree.py:91-96): validate branch 0, then average
branches 0 and 1 into branch 0 and validate again:

    python -m larvanet_tpu_torch.cli.state_dict_tree --restore_path m.pth \\
        --data_input_path LR --data_truth_path HR --num_branches 2 [--device cpu]

Prints the two mean RGB PSNRs (JAX's lines).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.eval import metrics


def average_branches(state: Dict[str, torch.Tensor], a: int, b: int) -> Dict[str, torch.Tensor]:
    """`state` with every key of branch `a` replaced by the mean of branch a's
    and branch b's (the port's state_dict: `branch_<i>.<j>.body.{0,2}`), in
    f32 as JAX's numpy mean (x + y) / 2."""
    prefix_a, prefix_b = "branch_%d." % a, "branch_%d." % b
    out = dict(state)
    for key, value in state.items():
        twin = prefix_b + key[len(prefix_a):]
        if key.startswith(prefix_a) and twin in state:
            out[key] = (value + state[twin]) / 2.0
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_loader="div2k_val_loader", default_model="TreeNet")
    parser.add_argument("--restore_path", type=str, required=True)
    args, remaining = parser.parse_known_args(argv)

    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    scale = scale_list[0]
    dataloader, _, remaining = common.setup_loader(args.dataloader, remaining, scale_list)
    model, _, remaining = common.setup_model(args.model, remaining, scale_list, device)
    common.warn_leftovers(remaining)
    model.restore(args.restore_path)
    print("restored the model")

    def validate(tag):
        psnrs = []
        for idx in range(dataloader.get_num_images()):
            inp, tru, _ = dataloader.get_image_pair(image_index=idx, scale=scale)
            o8 = metrics.image_to_uint8(model.upscale([inp], scale)[0])
            t8 = metrics.fit_truth_to_output(o8, metrics.image_to_uint8(tru))
            psnrs.append(metrics.psnr_rgb(o8, t8))
        print("%s: mean psnr=%.4f" % (tag, np.mean(psnrs)))

    validate("original (branch_0)")
    model.load_state_dict(average_branches(model.module.state_dict(), 0, 1))
    validate("averaged (mean of branch_0, branch_1)")
    print("finished")


if __name__ == "__main__":
    main()
