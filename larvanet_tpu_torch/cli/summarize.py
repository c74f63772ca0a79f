"""Model summary CLI: per-layer kernel / params / MACs table and FLOPs (the
port of larvanet_tpu/cli/summarize.py; reference summarize.py with its
vendored torchsummaryX, utils/torchsummaryX.py:57-61,119-167).

One row per leaf module that owns parameters: its name (the module's, the
reference's state_dict stem), kernel shape in the reference's [in, out, kh,
kw] (torch's OIHW weight with its first two axes swapped; a transposed
conv's weight is already [in, out, kh, kw]), its output shape printed
NCHW, its parameter count, and torchsummaryX's Mult-Adds: a conv's weight
elements times its output's spatial size; a weight of another rank (a
PReLU slope) counts its elements. Rows are sorted by the natural order of
their names, as JAX's are. Then the reference's "===== total =====" block.
Modules without parameters print no row (the MeanShifts hold buffers, as
JAX's fold holds none).

Shapes come from forward hooks on one forward of the plain module on the
CPU in float32 (the kernels' plain versions), whatever --device says, so
no card is needed for the table. The FLOPs come from
torch.utils.flop_counter.FlopCounterMode over that same forward, in place
of JAX's XLA cost analysis: it counts the matrix products and
convolutions (2 operations a multiply-add), not the elementwise work.

    python -m larvanet_tpu_torch.cli.summarize --model edsr --scales 4 \\
        [--input_height 96 --input_width 96] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import re

import numpy as np
import torch

from larvanet_tpu_torch.cli import common


def _natural_key(name: str):
    return tuple(int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name))


def _kernel_shape(module, weight: torch.Tensor):
    """[in, out, kh, kw] of a 4-D weight: torch's OIHW swapped, EBRN's
    transposed up-projection's (in, out, kh, kw) as it is."""
    from larvanet_tpu_torch.models.layers import UpProjection

    out_c, in_c = weight.shape[:2]
    if isinstance(module, UpProjection):
        in_c, out_c = out_c, in_c
    return [int(in_c), int(out_c), int(weight.shape[2]), int(weight.shape[3])]


def _walk(model, height: int, width: int):
    """(rows, flops) of one forward of the module on the CPU in float32 at a
    (1, height, width, 3) input."""
    from torch.utils.flop_counter import FlopCounterMode

    module = model.module
    if module is None:
        raise ValueError("the model is not prepared")
    if next(module.parameters()).device.type != "cpu":
        module = copy.deepcopy(module).cpu()
    module = module.float()
    leaves = {name: m for name, m in module.named_modules()
              if next(m.parameters(recurse=False), None) is not None}
    shapes, hooks = {}, []

    def hook(name):
        def record(_m, _inputs, out):
            while isinstance(out, (tuple, list)):
                out = out[0]
            shapes.setdefault(name, tuple(out.shape))
        return record

    for name, m in leaves.items():
        hooks.append(m.register_forward_hook(hook(name)))
    counter = FlopCounterMode(display=False)
    try:
        with torch.no_grad(), counter:
            module(torch.zeros((1, height, width, 3), dtype=torch.float32))
    finally:
        for h in hooks:
            h.remove()

    rows = []
    for name, m in leaves.items():
        params = dict(m.named_parameters(recurse=False))
        count = sum(int(p.numel()) for p in params.values())
        out = shapes.get(name)
        weight = params.get("weight")
        if weight is not None and weight.dim() == 4:
            ksize = _kernel_shape(m, weight)
            macs = int(weight.numel()) * (int(np.prod(out[1:3])) if out is not None else 0)
        else:  # a PReLU slope, etc.: its element count (torchsummaryX)
            ksize = list(next(iter(params.values())).shape)
            macs = sum(int(p.numel()) for k, p in params.items() if k != "bias")
        nchw = [out[0], out[3], out[1], out[2]] if out is not None and len(out) == 4 else None
        rows.append((name, ksize, nchw, count, macs))
    rows.sort(key=lambda r: _natural_key(r[0]))
    return rows, int(counter.get_total_flops())


def per_layer_table(model, height: int, width: int):
    """Rows of (layer_name, kernel_shape, output_shape_nchw, params, macs)."""
    return _walk(model, height, width)[0]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="edsr", help="Name of the model.")
    parser.add_argument("--scales", type=str, default="4", help="Scale of the input images.")
    common.add_device_flags(parser)
    parser.add_argument("--input_width", type=int, default=96, help="Width of the dummy input.")
    parser.add_argument("--input_height", type=int, default=96,
                        help="Height of the dummy input.")
    args, remaining = parser.parse_known_args(argv)

    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    model, _, remaining = common.setup_model(args.model, remaining, scale_list, device)
    common.warn_leftovers(remaining)

    rows, flops = _walk(model, args.input_height, args.input_width)
    # the reference torchsummaryX's "===== summary =====" format
    # (utils/torchsummaryX.py:133-141)
    print("")
    print("===== summary =====")
    print("layer_name\tmultiadds\tparams\tkernel_shape\toutput_shape")
    for name, ksize, out_nchw, params, macs in rows:
        print("%s\t%d\t%d\t%s\t%s" % (name, macs, params, ksize, out_nchw))
    print("===== ======= =====")
    print("===== total =====")
    print("- multiadds: %d" % (sum(r[4] for r in rows),))
    print("- params: %d" % (sum(r[3] for r in rows),))
    print("===== ===== =====")
    n_params = model.num_parameters()
    print("input: 1x%dx%dx3 (NHWC)" % (args.input_height, args.input_width))
    print("total params: %s" % ("{:,}".format(n_params),))
    print("torch FlopCounterMode forward FLOPs (matrix products and convolutions of the "
          "plain f32 forward on the CPU): %s (%.3f GFLOPs)"
          % ("{:,}".format(flops), flops / 1e9))
    print("approx MACs: %s" % ("{:,}".format(flops // 2),))
    return n_params, flops, rows


if __name__ == "__main__":
    main()
