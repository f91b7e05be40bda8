"""The port's checkpoint writer (``registry.CheckpointSaver``), the
counterpart of the JAX package's (tests/test_checkpoint_saver.py).

Overlapped saves both commit with their ``config.json``; a write that
fails mid-way leaves the earlier checkpoint and nothing under the new
final name, and its error reaches the caller at the next ``wait()``; the
copy a save hands to the writer is not changed by training that goes on;
``checkpoint_config`` falls back from the checkpoint's directory to the
run directory to the caller's config.
"""

import json
import os
import os.path as osp

import pytest
import torch

from dpft_tpu_torch.models import registry


def _state(value):
    return {"w": torch.full((8,), float(value)), "n": torch.tensor(3)}


def test_overlapped_saves_commit_with_config(tmp_path):
    saver = registry.CheckpointSaver()
    cfg = {"model": {"name": "dprt"}, "train": {"epochs": 2}}
    p0 = str(tmp_path / "a" / "ts_checkpoint_0000.pt")
    p1 = str(tmp_path / "b" / "ts_checkpoint_0001.pt")
    saver.save(_state(0), cfg, p0)          # in the background
    saver.save(_state(1), cfg, p1,          # finishes p0 first
               optimizer_state={"optimizer": {"state": {0: _state(2)}}})
    saver.wait()
    saver.wait()  # nothing in flight: no-op
    for path, value in ((p0, 0), (p1, 1)):
        with open(osp.join(osp.dirname(path), "config.json")) as f:
            assert json.load(f) == cfg
        got = torch.load(path, weights_only=True)
        assert torch.equal(got["w"], _state(value)["w"])
    optim = torch.load(registry.optimizer_state_path(p1), weights_only=True)
    assert torch.equal(optim["optimizer"]["state"][0]["w"], _state(2)["w"])
    assert registry.parse_checkpoint_name(p1) == (1, "ts")
    assert sorted(os.listdir(tmp_path / "b")) == [
        "config.json", "ts_checkpoint_0001.optim.pt", "ts_checkpoint_0001.pt"]


def test_save_copies_before_training_moves_on(tmp_path):
    """The writer gets a host copy: an in-place update right after
    ``save`` returns does not reach the file."""
    model = torch.nn.Linear(4, 4)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    saver = registry.CheckpointSaver()
    path = str(tmp_path / "ts_checkpoint_0000.pt")
    saver.save(model, {}, path)
    with torch.no_grad():
        model.weight.add_(1.0)
    saver.wait()
    got = torch.load(path, weights_only=True)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_failed_write_leaves_no_file_and_raises_at_wait(tmp_path,
                                                        monkeypatch):
    saver = registry.CheckpointSaver()
    cfg = {"train": {"epochs": 2}}
    p0 = str(tmp_path / "ts_checkpoint_0000.pt")
    p1 = str(tmp_path / "ts_checkpoint_0001.pt")
    saver.save(_state(0), cfg, p0, wait=True)
    real_save = torch.save

    def half_then_fail(obj, f, *args, **kwargs):
        f.write(b"\x80" * 64)  # half a file on the disk
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", half_then_fail)
    saver.save(_state(1), cfg, p1)
    with pytest.raises(OSError, match="disk gone"):
        saver.wait()
    monkeypatch.setattr(torch, "save", real_save)
    assert not osp.exists(p1)
    assert sorted(os.listdir(tmp_path)) == ["config.json",
                                            "ts_checkpoint_0000.pt"]
    assert torch.equal(torch.load(p0, weights_only=True)["w"],
                       _state(0)["w"])
    saver.wait()  # the error was raised once


def test_registry_save_commits_at_once(tmp_path):
    path = str(tmp_path / "ckpt" / "ts_checkpoint_0002.pt")
    registry.save(torch.nn.Linear(2, 3), {"x": 1}, path)
    assert torch.load(path, weights_only=True)["weight"].shape == (3, 2)
    with open(tmp_path / "ckpt" / "config.json") as f:
        assert json.load(f) == {"x": 1}


def test_checkpoint_config_fallback_chain(tmp_path):
    run_dir = tmp_path / "ts"
    ckpt = run_dir / "checkpoints" / "ts_checkpoint_0003.pt"
    os.makedirs(ckpt.parent)
    ckpt.write_bytes(b"")
    # 1) Beside the checkpoint (the saver writes it after the commit).
    with open(ckpt.parent / "config.json", "w") as f:
        json.dump({"source": "beside"}, f)
    assert registry.checkpoint_config(str(ckpt))["source"] == "beside"
    os.remove(ckpt.parent / "config.json")
    # 2) The run directory's snapshot covers a crash before that.
    with open(run_dir / "config.json", "w") as f:
        json.dump({"source": "run_dir"}, f)
    assert registry.checkpoint_config(str(ckpt))["source"] == "run_dir"
    os.remove(run_dir / "config.json")
    # 3) The caller's config; otherwise a clear error.
    assert registry.checkpoint_config(
        str(ckpt), fallback={"source": "cli"})["source"] == "cli"
    with pytest.raises(FileNotFoundError, match="No config found"):
        registry.checkpoint_config(str(ckpt))
