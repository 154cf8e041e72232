"""The yardstick: the plain PNG reader and writer, the plain filters
against the port's level-1 path, and the gaussian tables."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import pytest
import torch

from portbench.inputs import scene
from portbench.reference import filters as reference
from portbench.reference import png


def _rng(seed: int = 7) -> np.random.Generator:
    return np.random.default_rng(seed)


def test_the_writer_round_trips_through_the_reader_with_every_filter():
    img = scene.scene_image(_rng(), (48, 64, 3))
    img[:8] = 0                      # flat rows: None or Up
    img[8:16] = np.arange(64, dtype=np.uint8)[None, :, None] * 3   # Sub
    data = png.encode(img)
    rows = np.frombuffer(zlib.decompress(
        data[data.index(b"IDAT") + 4:][:-16]), np.uint8)
    assert rows.size == 48 * (64 * 3 + 1)
    kinds = set(rows.reshape(48, -1)[:, 0].tolist())
    assert len(kinds) >= 3, kinds
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_the_reader_undoes_each_filter_type(channels):
    rng = _rng(channels)
    img = rng.integers(0, 256, (9, 11, channels), np.uint8)
    x = img.reshape(9, -1).astype(np.int16)
    for kind, pred in enumerate(png.filter_predictions(x, channels)):
        lines = np.concatenate([np.full((9, 1), kind, np.uint8),
                                ((x - pred) & 0xFF).astype(np.uint8)], 1)
        ihdr = struct.pack(">IIBBBBB", 11, 9, 8,
                           {1: 0, 3: 2, 4: 6}[channels], 0, 0, 0)
        data = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                + png._chunk(b"IDAT", zlib.compress(lines.tobytes()))
                + png._chunk(b"IEND", b""))
        np.testing.assert_array_equal(png.decode(data), img)


def test_the_reader_reads_the_ports_encoder():
    from gpu_image_processing_tpu_torch.utils.image import encode_png

    img = scene.scene_image(_rng(3), (37, 53, 3))
    np.testing.assert_array_equal(png.decode(encode_png(img)), img)


def test_the_reader_refuses_a_broken_chunk():
    data = bytearray(png.encode(np.zeros((4, 4, 3), np.uint8)))
    data[40] ^= 0xFF
    with pytest.raises(png.PNGError):
        png.decode(bytes(data))


@pytest.mark.parametrize("radius,sigma", [(1, 0.5), (3, 2.0), (7, 3.3),
                                          (15, 20.0), (15, 0.5), (31, 8.0)])
def test_the_gaussian_table_is_the_ports_to_the_bit(radius, sigma):
    from gpu_image_processing_tpu_torch.ops.weights import gaussian_kernel_f32

    np.testing.assert_array_equal(
        reference.gaussian_table(radius, sigma).view(np.uint32),
        gaussian_kernel_f32(radius, sigma).view(np.uint32))


@pytest.mark.parametrize("shape", [(23, 31, 3), (2, 17, 29, 3), (19, 13, 1)])
def test_the_reference_is_the_ports_level_one_path(shape):
    from gpu_image_processing_tpu_torch.ops import ref
    from gpu_image_processing_tpu_torch.ops.weights import (
        gaussian_kernel_f32, weights_to_torch)

    img = torch.from_numpy(_rng(len(shape)).integers(0, 256, shape, np.uint8))
    for radius, sigma in ((1, 0.5), (3, 2.0), (9, 6.1)):
        w = weights_to_torch(gaussian_kernel_f32(radius, sigma),
                             torch.device("cpu"))
        assert torch.equal(reference.gaussian(img, sigma, radius),
                           ref.gaussian_blur(img, w, radius))
    for radius in (1, 5, 15):
        assert torch.equal(reference.box(img, radius),
                           ref.box_blur(img, radius))
    for level in (1, 2):
        assert torch.equal(reference.sobel(img, level), ref.sobel(img, level))


def test_the_reference_in_bfloat16_differs():
    img = torch.from_numpy(scene.scene_image(_rng(5), (40, 56, 3)))
    for f in ("gaussian", "box", "sobel"):
        f32 = reference.apply(img, f, 2, 2.0, 3)
        bf16 = reference.apply(img, f, 2, 2.0, 3, torch.bfloat16)
        assert (f32 != bf16).float().mean() > 0.05, f


def test_a_pool_derives_every_size_from_one_scene():
    out = scene.pool(_rng(), (30, 40), [(30, 40), (50, 70), (20, 10)], 2)
    assert [img.shape for img in out[(50, 70)]] == [(50, 70, 3)] * 2
    assert out[(30, 40)][0].flags.c_contiguous
    again = scene.pool(_rng(), (30, 40), [(30, 40), (50, 70), (20, 10)], 2)
    for size in out:
        for a, b in zip(out[size], again[size]):
            np.testing.assert_array_equal(a, b)
