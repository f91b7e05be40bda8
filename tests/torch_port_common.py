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
    if name == "gamma":                          # ConvNeXt's layer scale
        return rng.uniform(0.5, 1.5, size=shape)
    if name == "relative_position_bias_table":   # Swin's
        return 0.5 * rng.normal(size=shape)
    raise KeyError(name)


def random_variables(module, *args, seed=0, numpy_constants=False,
                     **kwargs):
    """Numpy variables for ``module.init(key, *args, **kwargs)``.
    ``numpy_constants``: what depends on no traced value is evaluated while
    tracing, for a module that turns such values into numpy arrays (the
    JAX package's Swin, its shift masks); not for one that reaches a
    Pallas kernel, which must capture no constant."""
    def init(key):
        return module.init(key, *args, **kwargs)

    if numpy_constants:
        with jax.ensure_compile_time_eval():
            shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    else:
        shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
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


def port_backbone_from_flax(name, in_channels, multi_scale, x, seed=1):
    """The JAX package's backbone ``name`` with random variables, and the
    port's with the same weights through state_dict_from_flax (strict).
    ``x``: an (B, H, W, C) numpy input. Returns (jax module, variables,
    port module)."""
    import jax.numpy as jnp

    from dpft_tpu.models.backbones import build_backbone as jbuild
    from dpft_tpu_torch.models.backbones import build_backbone
    from dpft_tpu_torch.models.convert import state_dict_from_flax

    config = {"in_channels": in_channels, "multi_scale": multi_scale}
    jmod = jbuild(name, config)
    variables = random_variables(jmod, jnp.asarray(x), False, seed=seed,
                                 numpy_constants="swin" in name.lower())
    state = state_dict_from_flax(
        {"params": {"backbones_x": variables["params"]},
         "batch_stats": {"backbones_x": variables.get("batch_stats", {})}},
        {"model": {"backbones": {"x": {"name": name}}}})
    port = build_backbone(name, config)
    port.load_state_dict({k[len("backbones.x."):]: v
                          for k, v in state.items()}, strict=True)
    return jmod, variables, port


def assert_stages_close(got, want, tol, where=""):
    """Port stage outputs (NCHW torch) against JAX's (NHWC): the same
    stages, each within ``tol`` of its largest element."""
    assert list(got) == list(want), (where, list(got), list(want))
    for k in want:
        w = np.asarray(want[k])
        g = got[k].detach().permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, (where, k, g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (where, k, err, np.abs(w).max())
