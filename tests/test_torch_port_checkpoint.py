"""Reference checkpoints through the port's registry.load, against JAX's.

``dpft_tpu_torch/models/torch_checkpoint.py`` reads the reference's own
checkpoint formats with ``torch.load(weights_only=True)``, a stub allowed
for exactly the globals that torch does not allow by itself. Held here:

 - the reference full-model pickle of ``tests/torch_dprt.py:
   build_tiny_dprt`` (classes of a module the loader never imports, a
   bias-free size head, numpy reconstructors among its globals) through
   the port's ``registry.load`` and through the JAX package's
   (``torch_checkpoint.import_checkpoint``): both forwards equal the
   pickled module's own within rtol 1e-4 / atol 2e-4 (the bound of
   test_torch_checkpoint.py); the same state as an ``.npz`` and as a dict
   under ``"state_dict"`` gives the pickle's bits;
 - the port's own model written as a reference pickle
   (``chip_smoke.write_reference_pickle``: ``dprt.*`` classes that exist
   only while it is written, and a ``torch.device``, a
   ``functools.partial``, a numpy array and ``torch.nn.functional.relu``
   beside the tensors) loads with its state's bits;
 - a pickle that calls ``os.system`` or ``builtins.exec`` raises
   ``ValueError`` and runs nothing; one that carries such a call beside a
   model loads the model and runs nothing; a file without parameters
   raises ``ValueError``;
 - ``python -m dpft_tpu_torch.evaluate`` and ``python -m
   dpft_tpu_torch.export`` (their ``main``, ``--device cpu``) take a
   reference pickle on the prepared mini K-Radar fixture.
"""

import builtins
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import (_Reduces, reference_extras,
                        write_malicious_pickles, write_reference_pickle)
from dpft_tpu.models import registry as jregistry
from dpft_tpu.utils.config import save_config
from dpft_tpu_torch import evaluate, export, prepare
from dpft_tpu_torch.data import init as init_dataset
from dpft_tpu_torch.data import load as load_dataset
from dpft_tpu_torch.evaluation.evaluator import to_device
from dpft_tpu_torch.models import registry, torch_checkpoint
from kradar_fixture import base_config, make_raw_kradar
from test_full_model_parity import make_batch, tiny_config
import torch_dprt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=2e-4)
KEYS = ("class", "center", "size", "angle")
NAME = "2026-08-20-12-00-00_checkpoint_0122"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config():
    config = tiny_config()
    # A bias-free reference size head: the loaders give it a zero bias.
    del config["model"]["head"]["size_bias_prior"]
    return config


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """build_tiny_dprt saved whole, with its config beside it, and its own
    forward on a numpy batch."""
    config = _config()
    module = torch_dprt.build_tiny_dprt(config, seed=3).eval()
    run = tmp_path_factory.mktemp("reference_run")
    path = str(run / f"{NAME}.pt")
    torch.save(module, path)
    save_config(config, str(run / "config.json"))
    batch_np = make_batch(np.random.default_rng(7))
    with torch.no_grad():
        want = module({k: torch.from_numpy(v) for k, v in batch_np.items()})
    return config, path, batch_np, {k: v.numpy() for k, v in want.items()}


def _forward(model, batch_np):
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in batch_np.items()})
    return {k: v.numpy() for k, v in out.items()}


def test_reference_pickle_through_both_registries(reference):
    config, path, batch_np, want = reference
    assert any(g.startswith("torch_dprt.") for g in
               torch.serialization.get_unsafe_globals_in_checkpoint(path))
    model, _, epoch, timestamp = registry.load(path, device="cpu")
    assert (epoch, timestamp) == (122, "2026-08-20-12-00-00")
    got = _forward(model, batch_np)
    jmodule, variables, jepoch, _ = jregistry.load(path)
    jout = jmodule.apply(variables, {k: jnp.asarray(v)
                                     for k, v in batch_np.items()},
                         train=False)
    assert jepoch == epoch
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
        np.testing.assert_allclose(got[key], np.asarray(jout[key]),
                                   err_msg=key, **TOL)
    size_bias = [v for k, v in model.state_dict().items()
                 if ".size_head." in k and k.endswith("bias")]
    assert size_bias and not any(v.any() for v in size_bias[-1:])


@pytest.mark.parametrize("form", ["npz", "state_dict"])
def test_npz_and_wrapped_state_dict_give_the_pickles_bits(reference, form,
                                                          tmp_path):
    config, path, _, _ = reference
    state = torch_checkpoint.read_state_dict(path)
    save_config(config, str(tmp_path / "config.json"))
    if form == "npz":
        other = str(tmp_path / f"{NAME}.npz")
        np.savez(other, **{k: v.numpy() for k, v in state.items()})
    else:
        other = str(tmp_path / f"{NAME}.pt")
        torch.save({"state_dict": state, "epoch": 122}, other)
    want = registry.load(path, device="cpu")[0].state_dict()
    got = registry.load(other, device="cpu")[0].state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_port_model_as_reference_pickle(tmp_path):
    config = tiny_config()
    model = registry.build("dprt", config, device="cpu", seed=5)
    path = str(tmp_path / f"{NAME}.pt")
    names = write_reference_pickle(model, path, reference_extras())
    assert not [g for g in names if g.startswith("dpft_tpu_torch")]
    assert "dprt.models.dpft.DPFT" in names
    assert {"functools.partial", "torch.nn.functional.relu",
            "numpy.ndarray"} <= set(names)
    loaded = registry.load(path, config, device="cpu")[0].state_dict()
    want = model.state_dict()
    assert set(loaded) == set(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):    # not read; stays 0
            torch.testing.assert_close(loaded[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("payload", ["system", "exec"])
def test_malicious_pickle_is_refused_and_runs_nothing(payload, tmp_path):
    marker = str(tmp_path / "ran")
    paths = dict(zip(("system", "exec"),
                     write_malicious_pickles(str(tmp_path), marker)))
    with pytest.raises(ValueError):
        registry.load(paths[payload], tiny_config(), device="cpu")
    assert not osp.exists(marker)


def test_code_beside_a_model_is_not_run(tmp_path):
    marker = str(tmp_path / "ran")
    model = registry.build("dprt", tiny_config(), device="cpu", seed=5)
    path = str(tmp_path / f"{NAME}.pt")
    write_reference_pickle(model, path, {"hook": _Reduces(
        builtins.exec, f"open({marker!r}, 'w').close()")})
    assert "builtins.exec" in \
        torch.serialization.get_unsafe_globals_in_checkpoint(path)
    loaded = registry.load(path, tiny_config(), device="cpu")[0]
    assert not osp.exists(marker)
    torch.testing.assert_close(loaded.fuser.query, model.fuser.query,
                               rtol=0, atol=0)


def test_file_without_parameters_raises(tmp_path):
    path = str(tmp_path / f"{NAME}.pt")
    torch.save({"epoch": 3, "note": "no weights"}, path)
    with pytest.raises(ValueError, match="no parameters"):
        registry.load(path, tiny_config(), device="cpu")


def test_evaluate_and_export_clis_take_a_reference_pickle(tmp_path):
    config = base_config()
    config["model"] = tiny_config()["model"]
    config["evaluate"]["metrics"] = {}
    config["train"]["logging"] = "epoch"
    root = str(tmp_path)
    cfg = osp.join(root, "config.json")
    save_config(config, cfg)
    processed = osp.join(root, "processed")
    prepare.main(make_raw_kradar(root), cfg, processed, device="cpu")
    run = osp.join(root, "run")
    os.makedirs(run)
    save_config(config, osp.join(run, "config.json"))
    ckpt = osp.join(run, f"{NAME}.pt")
    model = registry.build("dprt", config, device="cpu", seed=4)
    write_reference_pickle(model, ckpt, reference_extras())

    evaluate.main(processed, cfg, ckpt, osp.join(root, "eval"), device="cpu")
    with open(osp.join(root, "eval", "2026-08-20-12-00-00",
                       "results.json")) as f:
        assert "FLOPS" in f.read()
    artifact = osp.join(root, "model.pt2")
    export.main(processed, cfg, ckpt, artifact, batch=1, device="cpu")
    config = dict(config, train=dict(config["train"], batch_size=1))
    batch, _ = next(iter(load_dataset(
        init_dataset(config["dataset"], src=processed, split="test",
                     config=config), config=config, shuffle=False,
        pad_last=True)))
    batch = to_device(batch, torch.device("cpu"))
    got = export.load_exported(artifact).module()(batch)
    with torch.inference_mode():
        want = model(batch)
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)
