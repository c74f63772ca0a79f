"""The port's device-resident data pipeline (data/device_pipeline.py) and
the train CLIs' --device_pipeline against the JAX package's
(larvanet_tpu/data/device_pipeline.py), on the CPU.

The draws (image, y0, x0, k, flip) come from the port's own torch.Generator,
since jax.random's threefry stream has no torch counterpart; so the tests
re-derive JAX's draws from a key as `sample_batch` makes them, and hold the
port's crop and augmentation on those draws to JAX's batch bit for bit
(uint8 -> f32 is exact). The rest holds the port to itself: a chunk of N
steps against N host-loop train steps on the same batches, and a resumed
run against an uninterrupted one, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.data import device_pipeline as jdp
from larvanet_tpu_torch.cli import train, train_larva
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import device_pipeline as pdp
from larvanet_tpu_torch.data import io

SCALE, PATCH = 4, 6


def _images(sizes, seed=0):
    rng = np.random.default_rng(seed)
    lr = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    hr = [rng.integers(0, 256, (h * SCALE, w * SCALE, 3), dtype=np.uint8) for h, w in sizes]
    return lr, hr


def _jax_draws(pipe, key, batch, patch):
    """JAX's draws for `sample_batch(key, batch, patch)`: the keys split as
    its `one` splits them."""
    draws = []
    for k in jax.random.split(key, batch):
        k_img, k_y, k_x, k_rot, k_flip = jax.random.split(k, 5)
        idx = int(jax.random.randint(k_img, (), 0, pipe.dims.shape[0]))
        h, w = (int(v) for v in pipe.dims[idx])
        draws.append((idx, int(jax.random.randint(k_y, (), 0, h - patch)),
                      int(jax.random.randint(k_x, (), 0, w - patch)),
                      int(jax.random.randint(k_rot, (), 1, 5)),
                      bool(jax.random.bernoulli(k_flip))))
    return [torch.tensor([d[i] for d in draws]) for i in range(5)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crops_of_jax_draws_equal_jax_batch_bit_for_bit(seed):
    """Images of three sizes in one stack (JAX pads them, the port packs
    them); 8 samples cover every k and both flips at these seeds."""
    lr, hr = _images([(9, 11), (12, 8), (10, 10)], seed)
    jpipe = jdp.DevicePipeline.from_arrays(lr, hr, SCALE)
    ppipe = pdp.DevicePipeline.from_arrays(lr, hr, SCALE)
    key = jax.random.PRNGKey(seed)
    slot, y0, x0, k, flip = _jax_draws(jpipe, key, 8, PATCH)
    got = ppipe.crop_batch(slot, y0, x0, k, flip, PATCH)
    want = jpipe.sample_batch(key, 8, PATCH)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, torch.from_numpy(np.array(w)))


def test_bucketed_pipeline_buckets_and_crops_as_jax():
    """BucketedDevicePipeline.from_arrays: the buckets hold JAX's images in
    JAX's order (argsort by area, array_split); a batch from JAX's bucket
    draw, cropped by the port, equals JAX's bit for bit."""
    sizes = [(9, 11), (12, 8), (10, 10), (8, 8), (13, 9), (7, 12), (11, 11)]
    lr, hr = _images(sizes, 5)
    jb = jdp.BucketedDevicePipeline.from_arrays(lr, hr, SCALE, num_buckets=3)
    pb = pdp.BucketedDevicePipeline.from_arrays(lr, hr, SCALE, num_buckets=3)
    assert len(pb.buckets) == len(jb.pipelines)
    for bucket, jp in zip(pb.buckets, jb.pipelines):
        assert [tuple(d) for d in np.asarray(jp.dims)] == [sizes[i][:2] for i in bucket]
        for j, i in enumerate(bucket):
            h, w = sizes[i]
            assert np.array_equal(np.asarray(jp.lr[j, :h, :w]), lr[i])
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        k_bucket, k_sample = jax.random.split(key)
        b = int(jax.random.categorical(k_bucket, jnp.log(jb.probs)))
        slot, y0, x0, k, flip = _jax_draws(jb.pipelines[b], k_sample, 4, PATCH)
        got = pb.crop_batch(pb.bucket_start[b] + slot, y0, x0, k, flip, PATCH)
        want = jb.sample_batch(key, 4, PATCH)
        for g, w in zip(got, want):
            assert torch.equal(g, torch.from_numpy(np.array(w)))


def test_port_draws_stay_inside_the_images_and_its_bucket():
    """The port's own draws: every sample of a batch in one bucket, the
    crop inside its image, k in 1..4; the stream repeats from its seed."""
    sizes = [(9, 11), (12, 8), (10, 10), (8, 8), (13, 9)]
    lr, hr = _images(sizes, 3)
    pb = pdp.BucketedDevicePipeline.from_arrays(lr, hr, SCALE, num_buckets=2)
    gen = pb.generator(pdp.chunk_seed(3, 40))
    seen_k = set()
    for _ in range(20):
        slot, y0, x0, k, flip = pb.draw(gen, 6, PATCH)
        images = [pb.order[s] for s in slot.tolist()]
        assert len({next(i for i, b in enumerate(pb.buckets) if m in b) for m in images}) == 1
        for m, y, x in zip(images, y0.tolist(), x0.tolist()):
            assert 0 <= y < sizes[m][0] - PATCH and 0 <= x < sizes[m][1] - PATCH
        seen_k |= set(k.tolist())
    assert seen_k == {1, 2, 3, 4}
    a = pb.sample_batch(pb.generator(pdp.chunk_seed(3, 40)), 6, PATCH)
    b = pb.sample_batch(pb.generator(pdp.chunk_seed(3, 40)), 6, PATCH)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _edsr():
    m = get_model("edsr")
    m.parse_args(["--edsr_conv_features", "8", "--edsr_res_blocks", "1"])
    m.ema_decay = 0.9
    m.prepare([SCALE], device="cpu", is_training=True)
    return m


def test_a_chunk_equals_host_loop_steps_on_the_same_batches():
    """run_chunk's N steps against N `train_step`s of the host loop on the
    batches the same generator draws: parameters, Adam's state, the
    average and the mean loss, bit for bit."""
    lr, hr = _images([(10, 12), (12, 10)], 7)
    pipe = pdp.DevicePipeline.from_arrays(lr, hr, SCALE)
    chunked, looped = _edsr(), _edsr()
    n, seed, rate = 3, pdp.chunk_seed(0, 0), 1e-3
    mean = float(pdp.run_chunk(chunked, pipe, n, 2, PATCH, rate, seed))
    gen = pipe.generator(seed)
    losses = []
    looped.get_learning_rate = lambda: rate
    for _ in range(n):
        x, y = pipe.sample_batch(gen, 2, PATCH)
        losses.append(looped.train_step(x.numpy(), SCALE, y.numpy()))
    for a, b in zip(chunked.module.parameters(), looped.module.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(chunked.ema.average, looped.ema.average):
        assert torch.equal(a, b)
    assert mean == pytest.approx(sum(losses) / n, rel=1e-6)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """A DIV2K-layout set of two LR sizes (so the pipeline buckets)."""
    root = str(tmp_path_factory.mktemp("dp_set"))
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(16, 20), (14, 18), (16, 20)]):
        hr = rng.integers(0, 256, (3, 4 * h, 4 * w), dtype=np.uint8)
        lr = np.round(hr.reshape(3, h, 4, w, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    return root


def _set(root, prefix="data"):
    return ["--%s_input_path" % prefix, os.path.join(root, "LR"),
            "--%s_truth_path" % prefix, os.path.join(root, "HR")]


def _train(root, path, *extra):
    return train.main(["--model", "edsr", "--scales", "4", "--device", "cpu",
                       "--train_path", path, *_set(root), "--data_cached",
                       "--data_seed", "3", "--batch_size", "2", "--input_patch_size", "8",
                       "--edsr_conv_features", "8", "--edsr_res_blocks", "1",
                       "--edsr_learning_rate", "1e-3", "--device_pipeline", "2",
                       "--save_freq", "2", *extra])


def test_train_cli_device_pipeline_resumes_bit_for_bit(train_root, tmp_path, capsys):
    """train --device_pipeline 2: a chunk's line in JAX's grammar with the
    meter's rate; 6 steps straight against 4, then --restore_path latest to
    6: the last chunk's loss and the parameters bit for bit."""
    straight, losses = _train(train_root, str(tmp_path / "a"), "--max_steps", "6")
    out = capsys.readouterr().out
    assert "device pipeline: 3 images" in out and "avg " in out and "steps/s" in out
    assert sorted(losses) == [2, 4, 6] and all(np.isfinite(v) for v in losses.values())
    _train(train_root, str(tmp_path / "b"), "--max_steps", "4")
    resumed, rlosses = _train(train_root, str(tmp_path / "b"), "--max_steps", "6",
                              "--restore_path", "latest")
    assert rlosses[6] == losses[6]
    for a, b in zip(straight.module.parameters(), resumed.module.parameters()):
        assert torch.equal(a, b)


def test_train_larva_cli_device_pipeline_stops_chunks_at_validation(train_root, tmp_path,
                                                                    capsys):
    """train_larva --device_pipeline 4 with validation every 3 steps: chunks
    of 3 (the volume boundary comes first), validation before the first
    chunk and after each, a checkpoint at each; a resume from step 3
    repeats steps 4-6 bit for bit."""
    vps = 8 * 8 * 2 * 3

    def run(path, *extra):
        return train_larva.main(["--dataloader", "div2k_train_loader", "--device", "cpu",
                                 "--train_path", path, *_set(train_root),
                                 *_set(train_root, "val_data"), "--data_cached",
                                 "--data_seed", "3", "--batch_size", "2",
                                 "--input_patch_size", "8", "--num_blocks", "1,1",
                                 "--val_volume", str(3 * vps), "--device_pipeline", "4",
                                 *extra])

    model, losses = run(str(tmp_path / "a"), "--max_steps", "6")
    out = capsys.readouterr().out
    assert sorted(losses) == [3, 6] and out.count("psnr=") == 3
    assert sorted(os.listdir(str(tmp_path / "a"))).count("model_step3_vol0G.pth") == 1
    resumed, rlosses = run(str(tmp_path / "a"), "--max_steps", "6", "--restore_path",
                           os.path.join(str(tmp_path / "a"), "model_step3_vol0G.pth"))
    assert rlosses[6] == losses[6]
    for a, b in zip(model.module.parameters(), resumed.module.parameters()):
        assert torch.equal(a, b)
