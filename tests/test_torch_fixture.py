"""The port's fixture generator (larvanet_tpu_torch/data/fixture.py) against
the JAX package's, on the CPU: the port's standard and realistic trees
hash to the frozen manifests (tests/data/fixture_manifest.json,
fixture_real_manifest.json), `verify` catches a changed pixel, and a tree
written by either package verifies under the other.
"""

import json
import os

import numpy as np
import pytest
import torch

from larvanet_tpu.data import fixture as jax_fixture
from larvanet_tpu_torch.data import fixture, io

torch.set_num_threads(1)  # the numpy work is the same; keep to one thread as the other files

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _frozen(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def standard(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("standard"))
    return root, fixture.generate(root)


@pytest.fixture(scope="module")
def realistic(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("realistic"))
    return root, fixture.generate_realistic(root)


@pytest.mark.parametrize("tier, frozen", [("standard", "fixture_manifest.json"),
                                          ("realistic", "fixture_real_manifest.json")])
def test_port_fixture_matches_the_frozen_manifest(request, tier, frozen):
    root, manifest = request.getfixturevalue(tier)
    assert manifest == _frozen(frozen)
    with open(os.path.join(root, "MANIFEST.json")) as f:
        assert json.load(f) == manifest
    assert fixture.verify(root) == manifest


def test_verify_catches_a_changed_pixel(tmp_path):
    root = str(tmp_path)
    fixture.generate(root)
    rel = "x4/truth/img002.png"
    img = io.load_image_u8(os.path.join(root, rel)).copy()
    img[3, 5, 1] ^= 1
    io.save_image_hwc(img, os.path.join(root, rel))
    for verify in (fixture.verify, jax_fixture.verify):
        with pytest.raises(ValueError, match="drift in 1 file.*img002"):
            verify(root)


@pytest.mark.parametrize("tier", ["standard", "realistic"])
def test_port_tree_verifies_under_jax(request, tier):
    root, manifest = request.getfixturevalue(tier)
    assert jax_fixture.verify(root) == manifest


def test_jax_tree_verifies_under_the_port(tmp_path):
    root = str(tmp_path)
    manifest = jax_fixture.generate(root)
    assert fixture.verify(root) == manifest == _frozen("fixture_manifest.json")


def test_ensure_writes_then_verifies(tmp_path):
    root = str(tmp_path / "fx")
    first = fixture.ensure(root, shapes=((9, 11, 1, 0),), scales=(2,), datasets=())
    assert sorted(first["images"]) == ["x2/input/img000.png", "x2/truth/img000.png"]
    assert fixture.ensure(root) == first  # present: verified, not rewritten


def test_main_writes_and_verifies(tmp_path, capsys):
    root = str(tmp_path / "cli")
    fixture.main(["--root", root])
    fixture.main(["--root", root, "--verify"])
    out = capsys.readouterr().out
    assert "fixture written: 60 images" in out and "fixture OK: 60 images" in out


def test_box_downsample_and_pixel_hash_are_jax_s():
    rng = np.random.default_rng(2)
    hr = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
    lr = fixture._box_downsample(hr, 4)
    assert np.array_equal(lr, jax_fixture._box_downsample(hr, 4))
    assert fixture._pixel_hash(lr) == jax_fixture._pixel_hash(lr)
    shapes = fixture._realistic_shapes(np.random.default_rng(5), 12)
    assert shapes == jax_fixture._realistic_shapes(np.random.default_rng(5), 12)
