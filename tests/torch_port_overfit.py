"""The overfit recipe of tests/test_overfit_metrics.py, shared by the port's
overfit, trajectory and chain tests.

The recipe: the K-Radar fixture with two large boxes per frame (a Sedan at
20 m and a Sedan or a "Bus or Truck" at 45 m), the small model of
tests/test_e2e.py, AdamW at lr 3e-3 for 80 epochs, loss weights {2, 1, 1,
1, 1}, no per-step metric. ``jax_initial_variables`` draws the variables
that the JAX package's trainer starts from in that test (seed 0), so the
port can start where JAX starts: ``state_dict_from_flax`` carries them
across. The floors and their readings are chip_smoke.py's, which holds
the same recipe on the card.
"""

import os.path as osp

import numpy as np
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from chip_smoke import floor_readings, floor_report
from kradar_fixture import make_raw_kradar
from test_overfit_metrics import EPOCHS, _write_boxes


def overfit_config(two_class: bool, epochs: int = EPOCHS) -> dict:
    """The JAX test's config (``chip_smoke.overfit_config``, held equal to
    it key for key by test_torch_port_overfit_fixture.py), for ``epochs``
    epochs."""
    config = chip_smoke.overfit_config(two_class)
    config["train"]["epochs"] = epochs
    return config


def raw_tree(root: str, two_class: bool) -> str:
    """The fixture's raw tree with the recipe's two boxes per frame."""
    src = make_raw_kradar(root)
    _write_boxes(src, two_class)
    return src


def prepare(src: str, dst: str, config: dict) -> str:
    """Prepares ``src`` with the port on the CPU."""
    from dpft_tpu_torch.data import prepare as prepare_dataset

    config = {**config, "computing": {**config["computing"], "device": "cpu"}}
    prepare_dataset("kradar", config).prepare(src, dst)
    return dst


def jax_initial_variables(config: dict, processed: str) -> dict:
    """The variables the JAX package's trainer draws in the overfit test:
    ``set_seed(computing.seed)``'s key, split once, ``model.init`` on the
    first batch of the shuffled train loader in eval mode
    (dpft_tpu/training/trainer.py, ``CentralizedTrainer.train``)."""
    from dpft_tpu.data import init as init_dataset
    from dpft_tpu.data import load as load_dataset
    from dpft_tpu.models import build as build_model
    from dpft_tpu.utils.misc import set_seed

    rng = set_seed(config["computing"]["seed"])
    loader = load_dataset(init_dataset("kradar", src=processed,
                                       split="train", config=config),
                          config=config)
    batch, _ = next(iter(loader))
    init_rng, _ = jax.random.split(rng)
    model = build_model("dprt", config)
    # Jitted, the init gives the eager init's bits in a third of the time.
    variables = jax.jit(lambda key, b: model.init(key, b, train=False))(
        init_rng, jax.tree_util.tree_map(jnp.asarray, batch))
    return jax.tree_util.tree_map(np.asarray, variables)


def port_model(config: dict, variables: dict, dtype=torch.float32):
    """The port's model with the JAX variables, in ``dtype``."""
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.models.convert import state_dict_from_flax

    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    return model.to(dtype)


def in_dtype(tree: dict, dtype) -> dict:
    """Floating arrays of a numpy batch in ``dtype``."""
    return {k: v.astype(dtype) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in tree.items()}


class CastLoader:
    """A loader whose floating arrays come out in ``dtype``."""

    def __init__(self, loader, dtype):
        self.loader, self.dtype = loader, dtype

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch, targets in self.loader:
            yield in_dtype(batch, self.dtype), in_dtype(targets, self.dtype)


def port_loaders(config: dict, processed: str, dtype=np.float32):
    """The port's shuffled train loader and its unshuffled first batch,
    as the JAX test reads them."""
    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset

    dataset = init_dataset("kradar", src=processed, split="train",
                           config=config)
    loader = CastLoader(load_dataset(dataset, config=config), dtype)
    batch, targets = next(iter(load_dataset(dataset, config=config,
                                            shuffle=False)))
    return loader, (in_dtype(batch, dtype), in_dtype(targets, dtype))


def overfit_paths(root: str):
    return osp.join(root, "raw"), osp.join(root, "processed")


def port_overfit(root: str, two_class: bool, config=None):
    """The port's overfit from the JAX test's own seed-0 variables, in
    float32, through ``CentralizedTrainer.train`` with ``dst=None`` (no
    checkpoint), on the raw tree that the port prepares here (unless
    ``<root>/processed`` exists). Returns the loss history, the floor
    readings and the trained model."""
    from dpft_tpu_torch.evaluation.metric import build_metric
    from dpft_tpu_torch.training.trainer import CentralizedTrainer

    config = config or overfit_config(two_class)
    src, processed = overfit_paths(root)
    if not osp.isdir(processed):
        raw_tree(root, two_class)
        prepare(src, processed, config)
    model = port_model(config, jax_initial_variables(config, processed))
    loader, (batch, targets) = port_loaders(config, processed)
    trainer = CentralizedTrainer.from_config(config)
    history = trainer.train(model, loader, dst=None)["history"]
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    targets = {k: torch.as_tensor(v) for k, v in targets.items()}
    with torch.no_grad():
        out = model(batch)
    readings = floor_readings(
        out, targets, trainer.loss_fn.match(out, targets),
        build_metric(config["evaluate"])(out, targets), two_class)
    return history, readings, model


def report(history, readings) -> None:
    """Prints the run beside the floors."""
    print(floor_report(history, readings))
    for m in readings["matched"]:
        print(m)
