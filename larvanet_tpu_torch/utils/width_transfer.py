"""Function-preserving width transfer (larvanet_tpu/utils/width_transfer.py):
warm-start a wider model of the same topology (LarvaNet_w64 from a
48-channel LarvaNet run) from a narrower checkpoint, net2net-style.

Each conv kernel, as HWIO (kh, kw, Cin, Cout), embeds into the wider one as

    new[:, :, :Cin, :Cout] = old        # the trained function
    new[:, :, Cin:, :Cout] = 0          # old outputs ignore the new channels
    new[:, :, :,    Cout:] = eps*normal # new outputs start near-silent
    bias: new[:Cout] = old, new[Cout:] = 0

so the widened model computes the narrow model's function at step 0 while
the new channels still train. eps * normal is drawn from
`np.random.default_rng(seed)` in the HWIO shape (kh, kw, Cin', Cout' -
Cout), conv after conv in the module's parameter order, with std =
init_scale sqrt(2 / (kh kw Cin')): the JAX package's draws, bit for bit.
The port's state_dict holds OIHW weights, so each is seen as HWIO here and
written back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _widen_leaf(old: np.ndarray, new_shape, rng, init_scale: float) -> np.ndarray:
    """One leaf, HWIO kernel or bias (_widen_leaf, width_transfer.py:36-62)."""
    new_shape = tuple(new_shape)
    if old.shape == new_shape:
        return old
    if len(old.shape) != len(new_shape) or any(o > n for o, n in zip(old.shape, new_shape)):
        raise ValueError("cannot widen leaf %s -> %s" % (old.shape, new_shape))
    if old.ndim == 1:
        out = np.zeros(new_shape, old.dtype)
        out[: old.shape[0]] = old
        return out
    if old.ndim == 4:
        kh, kw, ci, co = old.shape
        nh, nw, nci, nco = new_shape
        if (kh, kw) != (nh, nw):
            raise ValueError("kernel window changed %s -> %s" % (old.shape, new_shape))
        std = init_scale * np.sqrt(2.0 / (kh * kw * nci))
        out = np.zeros(new_shape, old.dtype)
        out[:, :, :ci, :co] = old
        if nco > co:
            out[:, :, :, co:] = (rng.standard_normal((kh, kw, nci, nco - co)) * std
                                 ).astype(old.dtype)
        return out
    raise ValueError("unsupported leaf rank %d" % old.ndim)


def widen_state_dict(old: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor],
                     param_names, seed: int = 0,
                     init_scale: float = 0.1) -> Dict[str, torch.Tensor]:
    """Embed the narrow state_dict `old` into the keys and shapes of the
    wider `template` (a module's state_dict); `param_names` is the module's
    parameter order, in which the draws are made. Buffers must keep their
    shape. Raises naming the key where the topologies differ beyond
    width."""
    if set(old) != set(template):
        raise ValueError(
            "width transfer needs the same topology (only channel widths may "
            "differ): keys only in the checkpoint %s, only in the model %s"
            % (sorted(set(old) - set(template)), sorted(set(template) - set(old))))
    rng = np.random.default_rng(seed)
    out = {}
    for name in list(param_names) + [k for k in template if k not in set(param_names)]:
        o = old[name].detach().cpu().float().numpy()
        shape = tuple(template[name].shape)
        try:
            if o.ndim == 4:  # OIHW <-> HWIO
                hwio = (shape[2], shape[3], shape[1], shape[0])
                w = _widen_leaf(o.transpose(2, 3, 1, 0), hwio, rng, init_scale)
                out[name] = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
            else:
                out[name] = torch.from_numpy(np.ascontiguousarray(
                    _widen_leaf(o, shape, rng, init_scale)))
        except ValueError as e:
            raise ValueError("width transfer failed at %r: %s" % (name, e))
    return out
