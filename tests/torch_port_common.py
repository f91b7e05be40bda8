"""Shared helpers of the tests that hold the PyTorch port against JAX.

``random_variables`` gives any flax module a full variable tree drawn from
a numpy seed (shapes from ``jax.eval_shape`` of its init, so no init is
executed). Unlike the modules' own inits, which zero the MSDA offset and
attention kernels, random weights exercise every path.
"""

import numpy as np

import jax


def _leaf(rng, name, shape):
    if name in ("kernel", "in_proj_kernel"):
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(size=shape) / np.sqrt(fan_in)
    if name in ("bias", "in_proj_bias"):
        return 0.1 * rng.normal(size=shape)
    if name == "scale":
        return 1.0 + 0.1 * rng.normal(size=shape)
    if name == "mean":
        return 0.1 * rng.normal(size=shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, size=shape)
    if name == "query":
        return rng.uniform(size=shape)
    if name == "query_embedding":
        return rng.normal(size=shape)
    raise KeyError(name)


def random_variables(module, *args, seed=0, **kwargs):
    """Numpy variables for ``module.init(key, *args, **kwargs)``."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(rng, path[-1].key, s.shape).astype(np.float32),
        shapes)


def to_numpy(tree):
    """Variables as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def assert_trees_equal(got, want, where=""):
    assert set(got) == set(want), (where, sorted(set(got) ^ set(want)))
    for k in want:
        if hasattr(want[k], "items"):
            assert_trees_equal(got[k], want[k], f"{where}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{where}/{k}")
