"""The port's challenge-protocol metrics (larvanet_tpu_torch/eval/metrics.py)
against the JAX package's (larvanet_tpu/eval/metrics.py)."""

import numpy as np
import torch

from larvanet_tpu.eval import metrics as jax_metrics
from larvanet_tpu_torch.eval import metrics

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    out = rng.uniform(-20, 275, (17, 19, 3)).astype(np.float32)
    out[0, 0] = [0.5, 1.5, 2.5]  # round half to even
    truth = rng.uniform(0, 255, (20, 21, 3)).astype(np.float32)
    return out, truth


def test_image_to_uint8_and_psnr_match_jax_package():
    out, truth = _pair()
    q = metrics.image_to_uint8(out)
    np.testing.assert_array_equal(q, jax_metrics.image_to_uint8(out))
    assert list(q[0, 0]) == [0, 2, 2]
    t = jax_metrics.fit_truth_to_output(q, metrics.image_to_uint8(truth))
    assert metrics.psnr_rgb(q, t) == jax_metrics.psnr_rgb(q, t)


def test_device_psnr_quantizes_and_crops_like_the_host_protocol():
    out, truth = _pair(1)
    want = jax_metrics.psnr_rgb(
        metrics.image_to_uint8(out),
        metrics.image_to_uint8(truth)[: out.shape[0], : out.shape[1]])
    got = metrics.psnr_rgb_device(torch.from_numpy(out)[None],
                                  torch.from_numpy(truth)[None])
    assert abs(float(got) - want) < 1e-4
