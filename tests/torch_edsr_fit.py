"""A tiny EDSR of the port whose output spans the pixel range, saved as a
`.pth`: the CLIs' parity tests score it against JAX's CLIs (as drawn, the
clamp to [0, 255] would hide any error)."""

import torch

from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import io

TINY = ["--edsr_res_blocks", "2", "--edsr_conv_features", "8"]


def _fit(pm, lr_chw, target):
    """Rescale final_conv so the port model's output on `lr_chw` has the
    per-channel mean `target` and a std of 40."""
    module = pm.module
    shift = module.mean_inverse_shift.bias
    with torch.no_grad():
        f = pm.fwd_runtime(pm._input_to_device([lr_chw])) - shift
        a = 40.0 / float(f.std())
        module.final_conv.weight.mul_(a)
        module.final_conv.bias.copy_(a * (module.final_conv.bias - f.mean((0, 1, 2)))
                                     + torch.from_numpy(target).float() - shift)


def _fitted_pth(path, lr_path, truth_path, seed=0):
    pm = get_model("edsr")
    pm.parse_args(list(TINY))
    pm.prepare([4], device="cpu", seed=seed)
    _fit(pm, io.load_image_chw(lr_path), io.load_image_chw(truth_path).mean((1, 2)))
    torch.save(pm.module.state_dict(), path)
    return path
