"""The device-resident data pipeline (larvanet_tpu/data/device_pipeline.py):
the whole uint8 dataset lives on the card, and every step samples, crops,
rotates, flips and converts its patch batch there, so a chunk of N steps
(`run_chunk`, the train CLIs' `--device_pipeline N`) reads nothing back and
copies nothing to the card until its mean loss is read at its end.

The augmentation is the reference's (dataloaders/div2k_train_loader.py:
77-95), as JAX's `sample_batch` applies it: a crop aligned to the scale,
rot90 by k in 1..4 (k = 4 is no rotation) in the image plane, then a
horizontal flip. `crop_batch` applies it to given draws (image, y0, x0, k,
flip) with one gather from the stack, so the same draws give JAX's batch
bit for bit (uint8 -> f32 is exact).

The draws themselves come from the port's own `torch.Generator` on the
device, not from JAX's threefry stream, which has no torch counterpart: a
chunk seeds it from (data_seed, global_step) at its start (`chunk_seed`),
so a run resumed at a chunk boundary draws what an uninterrupted run
would. A step draws, in order: the bucket (one for the batch, with
probability proportional to its images, as JAX's `BucketedDevicePipeline`),
then per sample the image in the bucket, y0, x0 (uniform over the image's
valid origins, the reference's randint(dim - patch)), k and the flip.

Storage: the images are packed back to back in one flat uint8 buffer per
side (LR, HR), each with its offset and size, in bucket order; no padding.
`BucketedDevicePipeline.from_arrays` buckets the images as JAX does
(argsort by LR area, np.array_split into num_buckets); `DevicePipeline.
from_arrays` is one bucket.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def chunk_seed(data_seed: int, global_step: int) -> int:
    """The generator's seed for the chunk that starts at `global_step`."""
    return ((int(data_seed) & 0xFFFFFFFF) << 32) | (int(global_step) & 0xFFFFFFFF)


class DevicePipeline:
    """Uint8 LR / HR images resident on `device`, in buckets."""

    def __init__(self, lr_images: Sequence[np.ndarray], hr_images: Sequence[np.ndarray],
                 scale: int, buckets: Sequence[Sequence[int]], device="cpu"):
        self.scale = scale
        self.device = torch.device(device)
        self.buckets: List[List[int]] = [list(map(int, b)) for b in buckets if len(b)]
        order = [i for b in self.buckets for i in b]
        lr_parts, hr_parts, dims, lr_off, hr_off = [], [], [], [], []
        lo = ho = 0
        for i in order:
            a, b = np.ascontiguousarray(lr_images[i]), np.ascontiguousarray(hr_images[i])
            if a.dtype != np.uint8 or b.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
                raise ValueError("the device pipeline takes uint8 HWC RGB images")
            if (a.shape[0] * scale, a.shape[1] * scale) != b.shape[:2]:
                raise ValueError("HR dims must be LR dims * scale")
            lr_parts.append(a.reshape(-1))
            hr_parts.append(b.reshape(-1))
            dims.append(a.shape[:2])
            lr_off.append(lo)
            hr_off.append(ho)
            lo += a.size
            ho += b.size
        self.order = order
        self.lr = torch.from_numpy(np.concatenate(lr_parts)).to(self.device)
        self.hr = torch.from_numpy(np.concatenate(hr_parts)).to(self.device)
        self.dims = torch.tensor(dims, dtype=torch.int64, device=self.device)
        self.lr_off = torch.tensor(lr_off, dtype=torch.int64, device=self.device)
        self.hr_off = torch.tensor(hr_off, dtype=torch.int64, device=self.device)
        counts = [len(b) for b in self.buckets]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self.bucket_start = torch.tensor(starts, dtype=torch.int64, device=self.device)
        self.bucket_count = torch.tensor(counts, dtype=torch.int64, device=self.device)
        # cumulative bucket probabilities, proportional to the images in each
        self.bucket_cdf = torch.tensor(np.cumsum(counts) / float(sum(counts)),
                                       dtype=torch.float64, device=self.device)

    @classmethod
    def from_arrays(cls, lr_images, hr_images, scale: int, device="cpu"):
        return cls(lr_images, hr_images, scale, [list(range(len(lr_images)))], device)

    def nbytes(self) -> int:
        return int(self.lr.numel() + self.hr.numel())

    def __len__(self) -> int:
        return len(self.order)

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def draw(self, gen: torch.Generator, batch_size: int, patch: int):
        """One step's draws on the device: (slot, y0, x0, k, flip), slot the
        image's place in the stack (`order[slot]` is its index in the
        arrays), k in 1..4, flip a bool."""
        dev, b = self.device, batch_size
        u = torch.rand((1,), dtype=torch.float64, generator=gen, device=dev)
        bucket = torch.searchsorted(self.bucket_cdf, u, right=True).clamp_(
            max=len(self.buckets) - 1)
        count = self.bucket_count[bucket]
        pick = (torch.rand((b,), dtype=torch.float64, generator=gen, device=dev)
                * count).long()
        slot = self.bucket_start[bucket] + torch.minimum(pick, count - 1)
        h, w = self.dims[slot, 0], self.dims[slot, 1]
        origins = []
        for m in (h - patch, w - patch):
            r = torch.rand((b,), dtype=torch.float64, generator=gen, device=dev)
            origins.append(torch.minimum((r * m).long(), m - 1))
        k = torch.randint(1, 5, (b,), generator=gen, device=dev)
        flip = torch.rand((b,), generator=gen, device=dev) < 0.5
        return slot, origins[0], origins[1], k, flip

    def crop_batch(self, slot, y0, x0, k, flip, patch: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lr (B, p, p, 3), hr (B, p s, p s, 3)) f32 NHWC for the draws:
        the crops at (y0, x0) and (y0 s, x0 s), rot90 k times in the image
        plane (jnp.rot90's direction), then flipped along W where flip."""
        s = self.scale
        lr = self._gather(self.lr, self.lr_off, 1, slot, y0, x0, k, flip, patch)
        hr = self._gather(self.hr, self.hr_off, s, slot, y0 * s, x0 * s, k, flip, patch * s)
        return lr, hr

    def _gather(self, flat, offsets, mult, slot, y0, x0, k, flip, p):
        dev = flat.device
        i = torch.arange(p, device=dev).view(1, p, 1)
        j = torch.arange(p, device=dev).view(1, 1, p)
        j = torch.where(flip.view(-1, 1, 1), p - 1 - j, j)  # the flip reads column p-1-j
        kk = (k % 4).view(-1, 1, 1)
        # rot90(t, k)[i, j] = t[src_i, src_j] (counterclockwise, as jnp.rot90)
        si = torch.where(kk == 0, i, torch.where(kk == 1, j, torch.where(kk == 2, p - 1 - i,
                                                                          p - 1 - j)))
        sj = torch.where(kk == 0, j, torch.where(kk == 1, p - 1 - i, torch.where(kk == 2,
                                                                              p - 1 - j, i)))
        width = self.dims[slot, 1].view(-1, 1, 1) * mult
        base = offsets[slot].view(-1, 1, 1)
        pix = base + ((y0.view(-1, 1, 1) + si) * width + x0.view(-1, 1, 1) + sj) * 3
        idx = pix.unsqueeze(-1) + torch.arange(3, device=dev)
        return flat[idx].float()

    def sample_batch(self, gen: torch.Generator, batch_size: int, patch: int):
        """One step's batch: `draw`, then `crop_batch`."""
        slot, y0, x0, k, flip = self.draw(gen, batch_size, patch)
        return self.crop_batch(slot, y0, x0, k, flip, patch)


class BucketedDevicePipeline(DevicePipeline):
    """A variably sized set in size buckets (larvanet_tpu/data/
    device_pipeline.py:111-150): a batch comes from one bucket, chosen with
    probability proportional to its images."""

    @classmethod
    def from_arrays(cls, lr_images, hr_images, scale: int, num_buckets: int = 4,
                    device="cpu"):
        order = np.argsort([a.shape[0] * a.shape[1] for a in lr_images])
        buckets = np.array_split(order, min(num_buckets, len(order)))
        return cls(lr_images, hr_images, scale, [b.tolist() for b in buckets if len(b)],
                   device)


def pipeline_for(dataset, scale: int, device) -> DevicePipeline:
    """The dataset's LR images at `scale` and their truths cut to LR x scale
    (the extra HR rows and columns a set may carry are never sampled), in
    one bucket when every LR image has one size, else in buckets
    (cli/train.py:153-167)."""
    lr_imgs = [dataset.input_u8(scale, i) for i in range(len(dataset))]
    hr_imgs = [dataset.truth_u8(i)[: a.shape[0] * scale, : a.shape[1] * scale]
               for i, a in enumerate(lr_imgs)]
    if len({a.shape[:2] for a in lr_imgs}) > 1:
        return BucketedDevicePipeline.from_arrays(lr_imgs, hr_imgs, scale, device=device)
    return DevicePipeline.from_arrays(lr_imgs, hr_imgs, scale, device=device)


def run_chunk(model, pipeline: DevicePipeline, n_steps: int, batch_size: int, patch: int,
              lr: float, seed: int) -> torch.Tensor:
    """N optimizer steps on batches the pipeline samples on the device
    (make_device_train_fn, device_pipeline.py:153-180): each step the
    model's `_optimizer_step` at the chunk's `lr` (the loss, its gradients,
    the optimizer and the average). Returns the mean loss on the device;
    the caller advances `global_step`."""
    gen = pipeline.generator(seed)
    total = None
    for _ in range(n_steps):
        x, y = pipeline.sample_batch(gen, batch_size, patch)
        loss = model._optimizer_step(x, y, lr)
        total = loss if total is None else total + loss
    return total / n_steps
