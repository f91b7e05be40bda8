"""The port's entry points set what every run needs, and a checkpoint finds
the config of its run.

``prepare.main``, ``train.main`` and ``evaluate.main`` run in this process on
the mini K-Radar fixture with ``--device cpu``. Each must leave TF32 off for
matrix products and for cuDNN's convolutions (float32 is the parity dtype;
cuDNN's default is TF32), whatever the flags were before. A checkpoint under
``<run>/checkpoints/`` whose only ``config.json`` lies in ``<run>`` loads.
"""

import os
import os.path as osp
import shutil

import pytest
import torch

from dpft_tpu.utils.config import save_config
from dpft_tpu_torch import evaluate, prepare, train
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.utils.device import use_full_float32
from kradar_fixture import base_config, make_raw_kradar
from test_full_model_parity import tiny_config


def _tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    """Both flags on before the test, as they were after it."""
    before = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        before


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_entry"))
    config = base_config()
    config["model"] = tiny_config()["model"]
    config["evaluate"]["metrics"] = {}
    config["train"]["logging"] = "epoch"
    cfg = osp.join(root, "config.json")
    save_config(config, cfg)
    return root, make_raw_kradar(root), cfg, config


def test_use_full_float32_turns_both_flags_off(tf32_on):
    assert _tf32() == (True, True)
    use_full_float32()
    assert _tf32() == (False, False)


def test_entry_points_turn_tf32_off(tree, tf32_on):
    root, raw, cfg, _ = tree
    processed, log = osp.join(root, "processed"), osp.join(root, "log")

    prepare.main(raw, cfg, processed, device="cpu")
    assert _tf32() == (False, False)
    assert osp.isdir(osp.join(processed, "train"))

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    train.main(processed, cfg, log, device="cpu")
    assert _tf32() == (False, False)
    (timestamp,) = os.listdir(log)
    ckpt = osp.join(log, timestamp, "checkpoints",
                    f"{timestamp}_checkpoint_0000.pt")
    assert osp.isfile(ckpt)

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    evaluate.main(processed, cfg, ckpt, osp.join(root, "eval"), device="cpu")
    assert _tf32() == (False, False)
    assert osp.isfile(osp.join(root, "eval", timestamp, "results.json"))


def test_checkpoint_finds_the_config_of_its_run_directory(tree, tmp_path):
    _, _, _, config = tree
    run = tmp_path / "log" / "2026-01-01-00-00-00"
    ckpt = str(run / "checkpoints" / "2026-01-01-00-00-00_checkpoint_0003.pt")
    registry.save(registry.build("dprt", config, device="cpu"), config, ckpt)
    beside = run / "checkpoints" / "config.json"
    shutil.move(str(beside), str(run / "config.json"))   # one level up only

    assert registry.checkpoint_config(ckpt) == config
    model, loaded, epoch, timestamp = registry.load(ckpt, device="cpu")
    assert (epoch, timestamp) == (3, "2026-01-01-00-00-00")
    assert loaded == config and not model.training

    # The one beside the file wins over the run directory's.
    other = dict(config, computing=dict(config["computing"], seed=123))
    save_config(other, str(beside))
    assert registry.checkpoint_config(ckpt)["computing"]["seed"] == 123


def test_checkpoint_without_a_config_names_both_places(tree, tmp_path):
    _, _, _, config = tree
    run = tmp_path / "run"
    ckpt = str(run / "checkpoints" / "2026-01-01-00-00-00_checkpoint_0000.pt")
    registry.save(registry.build("dprt", config, device="cpu"), config, ckpt)
    os.remove(run / "checkpoints" / "config.json")
    with pytest.raises(FileNotFoundError) as info:
        registry.checkpoint_config(ckpt)
    assert str(run / "checkpoints" / "config.json") in str(info.value)
    assert str(run / "config.json") in str(info.value)
    with pytest.raises(FileNotFoundError):
        registry.load(ckpt, device="cpu")
    # A config handed in is the last resort.
    assert registry.checkpoint_config(ckpt, fallback=config) is config
