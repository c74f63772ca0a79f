"""TreeNet per-branch validation (larvanet_tpu/cli/validate_tree.py;
reference validate_tree.py:94-121): every branch of the shared trunk scored
on every val image, its RGB PSNR per image and its mean:

    python -m larvanet_tpu_torch.cli.validate_tree --restore_path m.pth \\
        --data_input_path LR --data_truth_path HR [--num_branches 2] \\
        [--pipeline_depth 2] [--device cpu]

A branch at a time over every image, each frame quantized to uint8 on the
device (the host's round-half-to-even and clip); with --pipeline_depth
N > 1, N frames are launched before the first pull (eval/pipeline.py
`dispatch`), 1 is the serial loop. `main` returns {branch: {"mean_psnr",
"per_image"}}.
"""

from __future__ import annotations

import argparse

import numpy as np

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.eval import metrics
from larvanet_tpu_torch.eval.pipeline import pipelined_upscale


def main(argv=None):
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_loader="div2k_val_loader", default_model="TreeNet")
    parser.add_argument("--restore_path", type=str, required=True)
    parser.add_argument("--restore_global_step", type=int, default=0)
    parser.add_argument("--pipeline_depth", type=int, default=1,
                        help="Dispatch-ahead depth (eval/pipeline.py): overlap each "
                             "image's pull and host PSNR with the next launch, per "
                             "branch. Byte-equal to the serial loop; 1 = serial.")
    args, remaining = parser.parse_known_args(argv)

    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    scale = scale_list[0]
    dataloader, _, remaining = common.setup_loader(args.dataloader, remaining, scale_list)
    model, _, remaining = common.setup_model(args.model, remaining, scale_list, device,
                                             global_step=args.restore_global_step)
    common.warn_leftovers(remaining)
    if not hasattr(model, "upscale_branch_device"):
        # JAX's CLI fails on the missing --num_branches; refused plainly here
        raise SystemExit("validate_tree scores TreeNet's branches; --model %s has none "
                         "(score it with larvanet_tpu_torch.cli.validate)" % (args.model,))
    model.restore(args.restore_path)
    print("restored the model")

    num_branches = model.args.num_branches
    branch_psnrs = {b: [] for b in range(num_branches)}
    per_image = {b: {} for b in range(num_branches)}
    n = dataloader.get_num_images()
    for b in range(num_branches):
        def items():
            for idx in range(n):
                inp, tru, name = dataloader.get_image_pair(image_index=idx, scale=scale)
                yield (name, tru), inp

        for (name, tru), o8, _ in pipelined_upscale(
                model, items(), scale, depth=args.pipeline_depth,
                dispatch=lambda imgs, b=b: model.upscale_branch_device(
                    imgs, scale, b, uint8=True)):
            t8 = metrics.fit_truth_to_output(o8, metrics.image_to_uint8(tru))
            psnr = metrics.psnr_rgb(o8, t8)
            branch_psnrs[b].append(psnr)
            per_image[b][name] = float(psnr)
    for idx, name in enumerate(per_image[0]):
        print("%d/%d %s: %s" % (idx + 1, n, name, " ".join(
            "b%d=%.2f" % (b, per_image[b][name]) for b in range(num_branches))))
    for b in range(num_branches):
        print("branch %d: mean psnr=%.4f" % (b, np.mean(branch_psnrs[b])))
    print("finished")
    return {b: {"mean_psnr": float(np.mean(branch_psnrs[b])), "per_image": per_image[b]}
            for b in range(num_branches)}


if __name__ == "__main__":
    main()
