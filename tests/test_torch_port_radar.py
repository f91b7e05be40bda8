"""The port's radar tesseract reduction against the JAX package.

The same cube, made from a numpy seed, goes through the port's plain
PyTorch version (what ``reduce_tesseract`` runs for a CPU tensor), the
Pallas kernels in interpret mode, the XLA reduction and the numpy
transliteration. Tolerance rtol 3e-4 / atol 3e-2, that of
tests/test_pallas_radar.py: float32 ``log10`` and the order of the sums
differ between the implementations. The doppler-of-max channel is a table
lookup at an argmax and must equal numpy's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpft_tpu.ops import radar_reduce as jax_radar
from dpft_tpu.ops.pallas.radar_reduce import reduce_tesseract_pallas
from dpft_tpu_torch.ops import radar_reduce as port_radar

TOL = dict(rtol=3e-4, atol=3e-2)

SHAPES = [
    (16, 32, 5, 9),       # odd elevation count
    (16, 32, 6, 9),       # even elevation count: two middle ranks averaged
    (8, 32, 6, 10),       # the ETL fixture's cube
    (2, 8, 16, 3, 5),     # a batch of frames
]


def _cube(shape, seed=0):
    """Uniform powers times a gain per doppler bin that spans 10 dB, as the
    doppler bins of a real cube differ. Without the gain the inner maxima
    are nearly equal in every doppler bin, and their variance over doppler
    (channel 5) lies below atol: a zero in its place would pass."""
    rng = np.random.default_rng(seed)
    power = rng.uniform(1e8, 1e12, size=shape)
    gain = 10.0 ** rng.uniform(-0.5, 0.5, size=(shape[-4], 1, 1, 1))
    return (power * gain).astype(np.float32)


def _numpy_planes(cube):
    if cube.ndim == 4:
        return port_radar.reduce_tesseract_np(cube)
    planes = [port_radar.reduce_tesseract_np(frame) for frame in cube]
    return (np.stack([ra for ra, _ in planes]),
            np.stack([ea for _, ea in planes]))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_every_channel_is_large_enough_for_the_tolerance(shape):
    """Each channel that TOL compares is typically above 30 times atol, so
    a channel that held zeros, or twice its values, would fail below."""
    for plane in _numpy_planes(_cube(shape)):
        for channel in (0, 1, 2, 4, 5):
            typical = np.median(np.abs(plane[..., channel]))
            assert typical > 30 * TOL["atol"], (channel, typical)


@pytest.mark.parametrize("channel", [0, 1, 2, 4, 5])
def test_tolerance_refuses_a_zeroed_or_doubled_channel(channel):
    cube = _cube((16, 32, 5, 9))
    for got, want in zip(port_radar.reduce_tesseract(torch.from_numpy(cube)),
                         _numpy_planes(cube)):
        for factor in (0.0, 2.0):
            wrong = got.numpy().copy()
            wrong[..., channel] *= factor
            with pytest.raises(AssertionError):
                np.testing.assert_allclose(wrong, want, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_xla_and_numpy(shape):
    cube = _cube(shape)
    ra, ea = port_radar.reduce_tesseract(torch.from_numpy(cube))
    assert ra.dtype == ea.dtype == torch.float32
    assert tuple(ra.shape) == (*shape[:-4], shape[-3], shape[-1], 6)
    assert tuple(ea.shape) == (*shape[:-4], shape[-2], shape[-1], 6)

    references = {
        "pallas": reduce_tesseract_pallas(jnp.asarray(cube), interpret=True,
                                          r_tile=8),
        "xla": jax_radar.reduce_tesseract(jnp.asarray(cube)),
        "numpy": _numpy_planes(cube),
    }
    for name, (ra_ref, ea_ref) in references.items():
        np.testing.assert_allclose(ra.numpy(), np.asarray(ra_ref), **TOL,
                                   err_msg=f"ra vs {name}")
        np.testing.assert_allclose(ea.numpy(), np.asarray(ea_ref), **TOL,
                                   err_msg=f"ea vs {name}")
    ra_np, ea_np = references["numpy"]
    np.testing.assert_array_equal(ra.numpy()[..., 3],
                                  ra_np[..., 3].astype(np.float32))
    np.testing.assert_array_equal(ea.numpy()[..., 3],
                                  ea_np[..., 3].astype(np.float32))


def test_numpy_copy_equals_the_original():
    cube = _cube((8, 32, 6, 10), seed=1)
    for got, want in zip(port_radar.reduce_tesseract_np(cube),
                         jax_radar.reduce_tesseract_np(cube)):
        np.testing.assert_array_equal(got, want)


def test_even_median_averages_the_two_middle_ranks():
    """torch.median takes the lower middle value; the port must not."""
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [8.0, 5.0, 6.0, 7.0]])
    np.testing.assert_array_equal(port_radar._median(x, 1).numpy(),
                                  np.median(x.numpy(), axis=1))
    np.testing.assert_array_equal(port_radar._median(x[:, :3], 1).numpy(),
                                  np.median(x.numpy()[:, :3], axis=1))


def test_argmax_takes_the_first_of_equal_maxima():
    cube = _cube((8, 32, 3, 5), seed=2)
    cube[5] = cube[2]                  # doppler bins 2 and 5 tie everywhere
    cube[2, :, 0, :] = cube[5, :, 0, :] = 1e13    # and hold the maximum
    ra, ea = port_radar.reduce_tesseract(torch.from_numpy(cube))
    ra_np, ea_np = port_radar.reduce_tesseract_np(cube)
    raster = port_radar.radar_info.doppler_raster
    assert np.all(ra.numpy()[..., 3] == np.float32(raster[2]))
    np.testing.assert_array_equal(ra.numpy()[..., 3],
                                  ra_np[..., 3].astype(np.float32))
    np.testing.assert_array_equal(ea.numpy()[..., 3],
                                  ea_np[..., 3].astype(np.float32))


def test_float64_cube_is_cast_to_float32():
    cube = _cube((8, 32, 6, 10), seed=3)
    ra64, ea64 = port_radar.reduce_tesseract(
        torch.from_numpy(cube.astype(np.float64)))
    ra32, ea32 = port_radar.reduce_tesseract(torch.from_numpy(cube))
    assert ra64.dtype == torch.float32
    np.testing.assert_array_equal(ra64.numpy(), ra32.numpy())
    np.testing.assert_array_equal(ea64.numpy(), ea32.numpy())


@pytest.mark.parametrize("wrapper", [port_radar.radar_reduce_ra,
                                     port_radar.radar_reduce_ea],
                         ids=["ra", "ea"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        wrapper(torch.from_numpy(_cube((8, 32, 6, 10))))
    assert wrapper.launches == before


def test_shapes_outside_the_contract_raise():
    with pytest.raises(ValueError, match="cube"):
        port_radar.reduce_tesseract_plain(torch.ones(8, 32, 6))
    with pytest.raises(ValueError, match="no row"):
        port_radar.reduce_tesseract(torch.ones(8, 4, 3, 5))
    with pytest.raises(ValueError, match="raster"):
        port_radar.reduce_tesseract(torch.ones(65, 8, 3, 5))
