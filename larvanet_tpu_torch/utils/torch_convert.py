"""State dicts across the boundary with the JAX package.

The port's modules use the reference PyTorch repo's state_dict keys, the
ones larvanet_tpu/utils/torch_convert.export_state_dict writes
(torch_convert.py:448-503,702-757). This module is the port's own copy
of that export for every family the JAX package exports (EDSR, the
LarvaNet family, the MSRR family, TreeNet, the REGOs, the EBRN and HRSR
families, MAMNet and IMDN),
so the tests can carry JAX parameters (nested dicts of numpy arrays)
into a port module without the port importing the JAX package. A rule
returns the key stem, or (stem, kind) for a transposed conv ("convT") or a
PReLU ("prelu"), torch_convert.py:376-401.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_RGB_MEAN = (114.4, 111.5, 103.0)


def _exp_edsr(path: str) -> str:
    m = re.match(r"res_block_(\d+)/conv([12])$", path)
    if m:
        return "res_blocks.%s.body.%d" % (m.group(1), 0 if m.group(2) == "1" else 2)
    if path in ("first_conv", "after_res_conv", "final_conv"):
        return path
    m = re.match(r"upsample/conv(\d+)$", path)
    if m:
        return "upsample.body.%d" % (2 * int(m.group(1)))
    raise KeyError(path)


def _exp_larvanet(path: str) -> str:
    """The LarvaNet family (torch_convert.py:482-503). The JAX EXPORT_RULES
    list the nine reference names; LarvaNet_w64 and LarvaLeg_w64 have the
    same parameter tree at another width, so they take the same rules here
    (the JAX package has no entry for them and cannot write their .pth)."""
    if path == "head":
        return "head.feature_extraction"
    m = re.match(r"body_(\d+)/block_(\d+)/conv([12])$", path)
    if m:
        return "body_%s.res_blocks.%s.body.%d" % (
            m.group(1), m.group(2), 0 if m.group(3) == "1" else 2)
    m = re.match(r"leg_(\d+)/recon/conv([12])$", path)  # the 'resblock' leg (_1c)
    if m:
        return "body_%s.leg.recon_block.body.%d" % (
            m.group(1), 0 if m.group(2) == "1" else 2)
    m = re.match(r"leg_(\d+)/recon([12])$", path)
    if m:
        return "body_%s.leg.recon_block.%d" % (m.group(1), 0 if m.group(2) == "1" else 2)
    if path == "tail_merge":
        return "tail.merge_conv"
    m = re.match(r"tail_recon([12])$", path)
    if m:
        return "tail.recon_block.%d" % (0 if m.group(1) == "1" else 2)
    raise KeyError(path)


def _exp_mamnet(path: str) -> str:
    """MAMNet (torch_convert.py:541-553): a MAMBlock's convs at body.0 /
    body.2, its MAMLayer at body.3 (the ICD squeeze and excite at conv_du.0
    / conv_du.2, the CSD at depthwise_conv2d); EDSR's names for the rest."""
    m = re.match(r"mam_block_(\d+)/mam/du([12])$", path)
    if m:
        return "res_blocks.%s.body.3.conv_du.%d" % (m.group(1), 0 if m.group(2) == "1" else 2)
    m = re.match(r"mam_block_(\d+)/mam/depthwise$", path)
    if m:
        return "res_blocks.%s.body.3.depthwise_conv2d" % (m.group(1),)
    m = re.match(r"mam_block_(\d+)/conv([12])$", path)
    if m:
        return "res_blocks.%s.body.%d" % (m.group(1), 0 if m.group(2) == "1" else 2)
    return _exp_edsr(path)


def _exp_imdn(path: str) -> str:
    """IMDN (torch_convert.py:514-526): an IMDBlock's 3x3 convs at
    conv1.0 ... conv4.0 (each a Sequential of the conv and its LeakyReLU),
    the 1x1 fuse at conv5, the upsample conv at upsample.body.0."""
    m = re.match(r"imd_block_(\d+)/conv([1-4])$", path)
    if m:
        return "res_blocks.%s.conv%s.0" % (m.group(1), m.group(2))
    m = re.match(r"imd_block_(\d+)/conv5$", path)
    if m:
        return "res_blocks.%s.conv5" % (m.group(1),)
    if path in ("first_conv", "after_res_conv"):
        return path
    if path == "upsample_conv":
        return "upsample.body.0"
    raise KeyError(path)


def _exp_msrr(path: str) -> str:
    """Full MSRR (torch_convert.py:555-564): the upsample's convs at body.0,
    body.3, ... (the reference's Sequential of conv, shuffle, LeakyReLU)."""
    m = re.match(r"res_block_(\d+)/conv([12])$", path)
    if m:
        return "res_blocks.%s.body.%d" % (m.group(1), 0 if m.group(2) == "1" else 2)
    m = re.match(r"upsample/conv(\d+)$", path)
    if m:
        return "upsample.body.%d" % (3 * int(m.group(1)))
    if path in ("first_conv", "HR_conv", "final_conv"):
        return path
    raise KeyError(path)


def _exp_msrr_reduced(path: str) -> str:
    """msrr_reduced and its ablations (torch_convert.py:505-511)."""
    m = re.match(r"res_block_(\d+)/conv([12])$", path)
    if m:
        return "res_blocks.%s.body.%d" % (m.group(1), 0 if m.group(2) == "1" else 2)
    if path == "first_conv":
        return path
    raise KeyError(path)


def _exp_msrr_test(path: str) -> str:
    """msrr_test (torch_convert.py:640-646)."""
    m = re.match(r"res_block_(\d+)/conv([12])$", path)
    if m:
        return "recon_trunk.%s.conv%s" % (m.group(1), m.group(2))
    if path in ("conv_first", "upconv1", "upconv2", "HRconv", "conv_last"):
        return path
    raise KeyError(path)


def _exp_dwsr(path: str) -> str:
    """dwsr_reduced (torch_convert.py:649-656): the depthwise kernels (3, 3,
    1, C) become the reference's (C, 1, 3, 3) as any HWIO kernel does."""
    m = re.match(r"res_block_(\d+)/(dw1|pw1|dw2|pw2)$", path)
    if m:
        body = {"dw1": 0, "pw1": 1, "dw2": 3, "pw2": 4}[m.group(2)]
        return "res_blocks.%s.body.%d" % (m.group(1), body)
    if path == "first_conv":
        return path
    raise KeyError(path)


def _exp_treenet(path: str) -> str:
    """TreeNet (torch_convert.py:528-538): the reference's common_parts
    Sequential (conv, LeakyReLU, ResBlocks) and one Sequential per branch."""
    if path == "first_conv":
        return "common_parts.0"
    m = re.match(r"common_block_(\d+)/conv([12])$", path)
    if m:
        return "common_parts.2.%s.body.%d" % (m.group(1), 0 if m.group(2) == "1" else 2)
    m = re.match(r"branch_(\d+)_block_(\d+)/conv([12])$", path)
    if m:
        return "branch_%s.%s.body.%d" % (
            m.group(1), m.group(2), 0 if m.group(3) == "1" else 2)
    raise KeyError(path)


def _make_exp_rego(serial: bool):
    """REGO-Net / REGO-serial (torch_convert.py:591-607): REGO-Net's blocks
    carry no repeat index (JAX's is always 0), REGO-serial's do."""
    def rule(path: str) -> str:
        m = re.match(r"RESB_(\d+)_(\d+)_(\d+)/conv([12])$", path)
        if m:
            body = 0 if m.group(4) == "1" else 2
            if serial:
                return "RESB_%s_%s_%s.body.%d" % (m.group(1), m.group(2), m.group(3), body)
            return "RESB_%s_%s.body.%d" % (m.group(2), m.group(3), body)
        if re.match(r"conv_(\d+)$", path) or path == "feature_extraction":
            return path
        if path == "SRrecon":
            return "SRrecon.body.0"
        raise KeyError(path)
    return rule


def _exp_ebrn(path: str):
    """Full EBRN (torch_convert.py:612-637): the PReLUs at the odd indices of
    their Sequentials, the up-projection a ConvTranspose2d."""
    m = re.match(r"fe(\d+)$", path)
    if m:
        return "feature_extract.%d" % (2 * int(m.group(1)))
    m = re.match(r"fe_prelu(\d+)$", path)
    if m:
        return "feature_extract.%d" % (2 * int(m.group(1)) + 1), "prelu"
    m = re.match(r"brm_(\d+)/up_block$", path)
    if m:
        return "brms.%s.up_block" % (m.group(1),), "convT"
    m = re.match(r"brm_(\d+)/down_block$", path)
    if m:
        return "brms.%s.down_block" % (m.group(1),)
    m = re.match(r"brm_(\d+)/(sr|bp)_flow/conv(\d+)$", path)
    if m:
        return "brms.%s.%s_flow.%d" % (m.group(1), m.group(2), 2 * int(m.group(3)))
    m = re.match(r"brm_(\d+)/(sr|bp)_flow/prelu(\d+)$", path)
    if m:
        return ("brms.%s.%s_flow.%d" % (m.group(1), m.group(2), 2 * int(m.group(3)) + 1),
                "prelu")
    m = re.match(r"fusion_(\d+)$", path)
    if m:
        return "fusion_layers.%s" % (m.group(1),)
    if path == "recon":
        return "recon_layer"
    raise KeyError(path)


def _exp_ebrn_rm(path: str) -> str:
    """ebrn_rm and ebrn_rm_BLI (torch_convert.py:567-578; the JAX export
    lists ebrn_rm alone, BLI has the same parameters)."""
    m = re.match(r"brm_(\d+)_conv([12])$", path)
    if m:
        return "brms.%s.body.%d" % (m.group(1), 0 if m.group(2) == "1" else 2)
    m = re.match(r"fusion_(\d+)$", path)
    if m:
        return "fusion_layers.%s" % (m.group(1),)
    if path == "upsample_conv":
        return "upsample.body.0"
    if path == "first_conv":
        return path
    raise KeyError(path)


def _exp_hrsr(path: str) -> str:
    """hrsr, hrsr_ and hrsr_c3 (torch_convert.py:581-588)."""
    m = re.match(r"(lr|hr)_block_(\d+)/conv([12])$", path)
    if m:
        return "%s_res_blocks.%s.body.%d" % (
            m.group(1), m.group(2), 0 if m.group(3) == "1" else 2)
    if path in ("first_conv", "middle_conv", "final_conv"):
        return path
    raise KeyError(path)


LARVANET_NAMES = ("LarvaNet", "LarvaNetV2", "LarvaLeg", "LarvaLegV2", "LarvaNet_0c",
                  "LarvaNet_1c", "LarvaNet_4c", "LarvaNet_skip", "LarvaNet_res",
                  "LarvaNet_w64", "LarvaLeg_w64")
MSRR_REDUCED_NAMES = ("msrr_reduced", "msrr_reduced_def_init", "msrr_reduced_NI",
                      "msrr_reduced_linear", "msrr_reduced_relu6", "msrr_reduced_leaky",
                      "msrr_reduced_meanshift")
EXPORT_RULES = {"edsr": _exp_edsr, "edsr_loss": _exp_edsr,
                **{name: _exp_larvanet for name in LARVANET_NAMES},
                "msrr": _exp_msrr, "msrr_test": _exp_msrr_test, "dwsr_reduced": _exp_dwsr,
                **{name: _exp_msrr_reduced for name in MSRR_REDUCED_NAMES},
                "TreeNet": _exp_treenet, "REGO-Net": _make_exp_rego(serial=False),
                "REGO-serial": _make_exp_rego(serial=True), "ebrn": _exp_ebrn,
                "ebrn_rm": _exp_ebrn_rm, "ebrn_rm_BLI": _exp_ebrn_rm,
                **{name: _exp_hrsr for name in ("hrsr", "hrsr_", "hrsr_c3")},
                "mamnet": _exp_mamnet, "imdn_aim2019": _exp_imdn}
# the state dicts with both MeanShifts (torch_convert.py:703-704; MSRR's are
# dead in its forward but in the reference's state dict; the LarvaNet family,
# TreeNet, ebrn_rm_BLI and HRSR have none) and with the forward one only
# (the REGOs, :705)
_MEANSHIFT_BOTH = {"edsr", "edsr_loss", "mamnet", "imdn_aim2019", "msrr",
                   "msrr_reduced_meanshift", "ebrn", "ebrn_rm"}
_MEANSHIFT_FWD_ONLY = {"REGO-Net", "REGO-serial"}


def _inv_conv(leaves) -> Dict[str, np.ndarray]:
    """HWIO kernel -> OIHW weight."""
    out = {"weight": np.ascontiguousarray(
        np.transpose(np.asarray(leaves["kernel"]), (3, 2, 0, 1)))}
    if "bias" in leaves:
        out["bias"] = np.asarray(leaves["bias"])
    return out


def _inv_conv_transpose(leaves) -> Dict[str, np.ndarray]:
    """JAX's input-dilated conv kernel, HWIO with the spatial axes flipped ->
    torch's ConvTranspose2d weight (C_in, C_out, kH, kW)
    (torch_convert.py:455-463)."""
    k = np.asarray(leaves["kernel"])[::-1, ::-1]
    out = {"weight": np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))}
    if "bias" in leaves:
        out["bias"] = np.asarray(leaves["bias"])
    return out


_INVERSE = {"conv": _inv_conv, "convT": _inv_conv_transpose,
            "prelu": lambda leaves: {"weight": np.asarray(leaves["slope"])}}


def _synthesize_dead_brm(state: Dict[str, np.ndarray]) -> None:
    """Full EBRN's last BRM: the reference builds its down_block and bp_flow
    though its forward never runs them, and a strict load wants their keys;
    JAX has no such parameters, so they are written as zeros (the PReLUs at
    0.25), as JAX's export writes them (torch_convert.py:760-783)."""
    n = 1 + max(int(re.match(r"brms\.(\d+)\.", k).group(1))
                for k in state if k.startswith("brms."))
    last = "brms.%d." % (n - 1)
    if last + "down_block.weight" in state:
        return
    c, k = state[last + "up_block.weight"].shape[0], state[last + "up_block.weight"].shape[2]
    state[last + "down_block.weight"] = np.zeros((c, c, k, k), np.float32)
    state[last + "down_block.bias"] = np.zeros((c,), np.float32)
    for i in (0, 2, 4):
        state[last + "bp_flow.%d.weight" % i] = np.zeros((c, c, 3, 3), np.float32)
        state[last + "bp_flow.%d.bias" % i] = np.zeros((c,), np.float32)
    for i in (1, 3, 5):
        state[last + "bp_flow.%d.weight" % i] = np.full((c,), 0.25, np.float32)


def _meanshift_entries(model_name: str) -> Dict[str, np.ndarray]:
    """The intended identity + (+/-)mean shifts."""
    shifts = []
    if model_name in _MEANSHIFT_BOTH:
        shifts = [("mean_shift", 1.0), ("mean_inverse_shift", -1.0)]
    elif model_name in _MEANSHIFT_FWD_ONLY:
        shifts = [("mean_shift", 1.0)]
    out = {}
    for name, sign in shifts:
        out[name + ".weight"] = np.eye(3, dtype=np.float32).reshape(3, 3, 1, 1)
        out[name + ".bias"] = sign * np.asarray(_RGB_MEAN, dtype=np.float32)
    return out


def _param_groups(params, prefix: str = "") -> Iterator[Tuple[str, Dict]]:
    """(path, leaves) for each dict that holds a conv's kernel/bias or a
    PReLU's slope."""
    if "kernel" in params or "slope" in params:
        yield prefix, params
        return
    for key, val in params.items():
        sub = prefix + "/" + str(key) if prefix else str(key)
        if not hasattr(val, "items"):
            raise KeyError("unexpected bare leaf at %s" % sub)
        yield from _param_groups(dict(val), sub)


def state_dict_from_jax_params(params_np, model_name: str) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of numpy arrays) -> the port's
    state_dict, key-complete for a strict load (MeanShift included)."""
    rule = EXPORT_RULES[model_name]
    state: Dict[str, np.ndarray] = {}
    for path, leaves in _param_groups(dict(params_np)):
        spec = rule(path)
        stem, kind = spec if isinstance(spec, tuple) else (spec, "conv")
        for suffix, value in _INVERSE[kind](leaves).items():
            state[stem + "." + suffix] = value
    state.update(_meanshift_entries(model_name))
    if model_name == "ebrn":
        _synthesize_dead_brm(state)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()}


def _c12(body: str) -> str:
    """A ResBlock's body index (0 or 2) -> JAX's conv1 / conv2."""
    return "1" if body == "0" else "2"


_EDSR_PATHS = (
    (r"res_blocks\.(\d+)\.body\.([02])$", lambda m: "res_block_%s/conv%s" % (m[1], _c12(m[2]))),
    (r"upsample\.body\.(\d+)$", lambda m: "upsample/conv%d" % (int(m[1]) // 2)),
    (r"(first_conv|after_res_conv|final_conv)$", lambda m: m[1]))
_EBRN_RM_PATHS = (
    (r"brms\.(\d+)\.body\.([02])$", lambda m: "brm_%s_conv%s" % (m[1], _c12(m[2]))),
    (r"fusion_layers\.(\d+)$", lambda m: "fusion_%s" % m[1]),
    (r"upsample\.body\.0$", lambda m: "upsample_conv"),
    (r"(first_conv)$", lambda m: m[1]))
_MSRR_REDUCED_PATHS = (
    (r"res_blocks\.(\d+)\.body\.([02])$", lambda m: "res_block_%s/conv%s" % (m[1], _c12(m[2]))),
    (r"(first_conv)$", lambda m: m[1]))
_LARVANET_PATHS = (
    (r"head\.feature_extraction$", lambda m: "head"),
    (r"body_(\d+)\.res_blocks\.(\d+)\.body\.([02])$",
     lambda m: "body_%s/block_%s/conv%s" % (m[1], m[2], _c12(m[3]))),
    (r"body_(\d+)\.leg\.recon_block\.body\.([02])$",
     lambda m: "leg_%s/recon/conv%s" % (m[1], _c12(m[2]))),
    (r"body_(\d+)\.leg\.recon_block\.([02])$", lambda m: "leg_%s/recon%s" % (m[1], _c12(m[2]))),
    (r"tail\.merge_conv$", lambda m: "tail_merge"),
    (r"tail\.recon_block\.([02])$", lambda m: "tail_recon%s" % _c12(m[1])))


def _rego_paths(serial: bool):
    resb = ((r"RESB_(\d+)_(\d+)_(\d+)\.body\.([02])$",
             lambda m: "RESB_%s_%s_%s/conv%s" % (m[1], m[2], m[3], _c12(m[4]))) if serial else
            (r"RESB_(\d+)_(\d+)\.body\.([02])$",
             lambda m: "RESB_0_%s_%s/conv%s" % (m[1], m[2], _c12(m[3]))))
    return (resb, (r"(conv_\d+|feature_extraction)$", lambda m: m[1]),
            (r"SRrecon\.body\.0$", lambda m: "SRrecon"))


# the inverse of each family's export rule: a torch module's key stem -> the
# JAX path it comes from, (pattern, path) tried in order; a path whose rule
# makes a PReLU is marked by its leaf, `slope`
_JAX_PATHS = {
    "edsr": _EDSR_PATHS, "edsr_loss": _EDSR_PATHS,
    **{name: _LARVANET_PATHS for name in LARVANET_NAMES},
    "mamnet": ((r"res_blocks\.(\d+)\.body\.3\.conv_du\.([02])$",
                lambda m: "mam_block_%s/mam/du%s" % (m[1], _c12(m[2]))),
               (r"res_blocks\.(\d+)\.body\.3\.depthwise_conv2d$",
                lambda m: "mam_block_%s/mam/depthwise" % m[1]),
               (r"res_blocks\.(\d+)\.body\.([02])$",
                lambda m: "mam_block_%s/conv%s" % (m[1], _c12(m[2]))),
               *_EDSR_PATHS[1:]),
    "imdn_aim2019": ((r"res_blocks\.(\d+)\.conv([1-4])\.0$",
                      lambda m: "imd_block_%s/conv%s" % (m[1], m[2])),
                     (r"res_blocks\.(\d+)\.conv5$", lambda m: "imd_block_%s/conv5" % m[1]),
                     (r"(first_conv|after_res_conv)$", lambda m: m[1]),
                     (r"upsample\.body\.0$", lambda m: "upsample_conv")),
    "msrr": (_MSRR_REDUCED_PATHS[0],
             (r"upsample\.body\.(\d+)$", lambda m: "upsample/conv%d" % (int(m[1]) // 3)),
             (r"(first_conv|HR_conv|final_conv)$", lambda m: m[1])),
    **{name: _MSRR_REDUCED_PATHS for name in MSRR_REDUCED_NAMES},
    "msrr_test": ((r"recon_trunk\.(\d+)\.conv([12])$",
                   lambda m: "res_block_%s/conv%s" % (m[1], m[2])),
                  (r"(conv_first|upconv1|upconv2|HRconv|conv_last)$", lambda m: m[1])),
    "dwsr_reduced": ((r"res_blocks\.(\d+)\.body\.([0134])$",
                      lambda m: "res_block_%s/%s" % (m[1], {"0": "dw1", "1": "pw1", "3": "dw2",
                                                           "4": "pw2"}[m[2]])),
                     (r"(first_conv)$", lambda m: m[1])),
    "TreeNet": ((r"common_parts\.0$", lambda m: "first_conv"),
                (r"common_parts\.2\.(\d+)\.body\.([02])$",
                 lambda m: "common_block_%s/conv%s" % (m[1], _c12(m[2]))),
                (r"branch_(\d+)\.(\d+)\.body\.([02])$",
                 lambda m: "branch_%s_block_%s/conv%s" % (m[1], m[2], _c12(m[3])))),
    "REGO-Net": _rego_paths(serial=False), "REGO-serial": _rego_paths(serial=True),
    "ebrn": ((r"feature_extract\.(\d+)$",
              lambda m: ("fe%d" % (int(m[1]) // 2)) if int(m[1]) % 2 == 0
              else ("fe_prelu%d" % (int(m[1]) // 2), "slope")),
             (r"brms\.(\d+)\.(up_block|down_block)$", lambda m: "brm_%s/%s" % (m[1], m[2])),
             (r"brms\.(\d+)\.(sr|bp)_flow\.(\d+)$",
              lambda m: ("brm_%s/%s_flow/conv%d" % (m[1], m[2], int(m[3]) // 2))
              if int(m[3]) % 2 == 0
              else ("brm_%s/%s_flow/prelu%d" % (m[1], m[2], int(m[3]) // 2), "slope")),
             (r"fusion_layers\.(\d+)$", lambda m: "fusion_%s" % m[1]),
             (r"recon_layer$", lambda m: "recon")),
    "ebrn_rm": _EBRN_RM_PATHS, "ebrn_rm_BLI": _EBRN_RM_PATHS,
    **{name: ((r"(lr|hr)_res_blocks\.(\d+)\.body\.([02])$",
               lambda m: "%s_block_%s/conv%s" % (m[1], m[2], _c12(m[3]))),
              (r"(first_conv|middle_conv|final_conv)$", lambda m: m[1]))
       for name in ("hrsr", "hrsr_", "hrsr_c3")},
}


def jax_leaf(name: str, model_name: str) -> Tuple[str, ...]:
    """The JAX parameter path of the port's parameter `name` (a state_dict
    key of `model_name`'s module), as its tuple of keys: the path the
    export rule maps onto the key's stem, then the leaf (kernel, bias or a
    PReLU's slope). KeyError where no path maps onto it."""
    stem, _, suffix = name.rpartition(".")
    for pattern, path in _JAX_PATHS[model_name]:
        m = re.match(pattern, stem)
        if m:
            found = path(m)
            prelu = isinstance(found, tuple)
            found = found[0] if prelu else found
            if suffix == "bias":
                leaf = "bias"
            else:
                leaf = "slope" if prelu else "kernel"
            return tuple(found.split("/")) + (leaf,)
    raise KeyError(name)


def jax_ravel_order(names, model_name: str) -> list:
    """Indices into `names` (the port's parameter names of `model_name`'s
    module) in the order of JAX's ravel_pytree over its parameter tree:
    its leaves in sorted key order (larvanet_tpu/models/base.py:265-300,
    the --fused_opt vector). A name whose path JAX's tree lacks (full
    EBRN's dead last BRM, which only the reference builds) sorts among them
    by that path; a name no rule maps onto follows, in the given order."""
    keyed, rest = [], []
    for i, name in enumerate(names):
        try:
            keyed.append((jax_leaf(name, model_name), i))
        except KeyError:
            rest.append(i)
    return [i for _, i in sorted(keyed)] + rest


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A `.pth` state_dict on the CPU. weights_only=True: a state_dict is
    plain tensors, and a full unpickle could run arbitrary code."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict):
        raise ValueError("%s does not hold a state_dict" % (path,))
    return state


def unpack_jax_pair_record(rec) -> Dict[str, object]:
    """One of JAX's quantized pair records (larvanet_tpu/ops/packed/pairs.py
    make_pair_runner's `quant`: ka, kb int8 width-packed kernels (3, 2, 2C,
    2F); sa, sb, ba, bb per packed channel (2F,); s_in, s_mid floats) ->
    the unpacked record: ka, kb int8 HWIO (3, 3, C, F), sa, sb f32 (F,), ba,
    bb (F,) as numpy, s_in, s_mid floats. A packed entry [ky, w, e C + ci,
    d F + co] is the original tap k[ky, 2w + e - d, ci, co] (core.py
    `_route`); both column offsets d hold every tap, and the check that they
    agree guards the unpacking."""
    out: Dict[str, object] = {"s_in": float(rec["s_in"]), "s_mid": float(rec["s_mid"])}
    for conv in ("a", "b"):
        p = np.asarray(rec["k" + conv])
        c, f = p.shape[2] // 2, p.shape[3] // 2
        d0 = np.stack([p[:, 0, :c, :f], p[:, 0, c:, :f], p[:, 1, :c, :f]], axis=1)
        d1 = np.stack([p[:, 0, c:, f:], p[:, 1, :c, f:], p[:, 1, c:, f:]], axis=1)
        s = np.asarray(rec["s" + conv], np.float32).reshape(-1)
        b = np.asarray(rec["b" + conv], np.float32).reshape(-1)
        if (not np.array_equal(d0, d1) or not np.array_equal(s[:f], s[f:])
                or not np.array_equal(b[:f], b[f:]) or np.any(p[:, 0, :c, f:])):
            raise ValueError("pair record %s is not a width-packed SAME 3x3 conv" % conv)
        out["k" + conv] = np.ascontiguousarray(d0.astype(np.int8))
        out["s" + conv], out["b" + conv] = s[:f].copy(), b[:f].copy()
    return out
