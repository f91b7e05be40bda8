"""``computing.remat`` of the port: one train step with the backbones
recomputed in the backward against the same step without.

The tiny config of test_torch_port_train.py (three ResNet18 views, two
fusion iterations, dropout 0) at four times make_batch's size, float32 on
the CPU, weights from the port's seeded init. With remat the backbones'
activations are recomputed in the backward (``torch.utils.checkpoint``);
on the CPU the recompute gives the forward's bits, so every gradient,
every parameter after one AdamW step and every BatchNorm buffer
(``num_batches_tracked`` included: the recompute must not count a second
batch) is equal bit for bit, in one process and on two gloo ranks
(``parallel.distribute``: global BatchNorm, whose all-gather runs again in
the recompute, and FSDP2). The state_dict keys are the same, and the
forward saves fewer bytes for the backward, as tests/test_remat.py holds
for the JAX package's lifted remat.
"""

import copy

import numpy as np
import pytest
import torch

import torch_parallel_worker as workers
from dpft_tpu_torch.models import registry
from test_torch_port_train import _torch, make_batch_4x, make_targets
from test_torch_port_train_seeds import _config


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _job(B=2):
    rng = np.random.default_rng(3)
    batch = _torch(make_batch_4x(rng, B=B))
    targets = _torch(make_targets(rng, B=B, n_real=(4, 3, 5, 2)[:B]))
    state = registry.build("dprt", _config(), device="cpu",
                           seed=2).state_dict()
    return {"config": _config(), "batch": batch, "targets": targets,
            "state": state}


def _remat(config, on):
    config = copy.deepcopy(config)
    config["computing"]["remat"] = on
    return config


def _assert_steps_equal(a, b):
    assert a["scalars"] == b["scalars"]
    for part in ("grads", "params", "buffers"):
        assert a[part].keys() == b[part].keys(), part
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)


def test_remat_step_equals_plain_step_bit_for_bit():
    job = _job()
    off, on = (workers.remat_step(_remat(job["config"], r), job["state"],
                                  job["batch"], job["targets"])
               for r in (False, True))
    _assert_steps_equal(on, off)
    assert on["keys"] == off["keys"] == list(job["state"])
    # One batch counted once.
    assert all(int(v) == 1 for k, v in on["buffers"].items()
               if k.endswith("num_batches_tracked"))


def test_remat_saves_fewer_bytes_for_the_backward():
    job = _job()
    saved = {}
    for on in (False, True):
        model = registry.build("dprt", _remat(job["config"], on),
                               device="cpu")
        model.load_state_dict(job["state"])
        model.train()
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = model(job["batch"])
        saved[on] = total[0]
        sum(v.float().sum() for v in out.values()).backward()
    # The backbones hold most of the forward's activations.
    assert saved[True] < 0.5 * saved[False], saved


def test_remat_step_on_two_ranks_equals_plain_step(tmp_path):
    job = _job(B=4)
    workers.save(job, tmp_path, "remat_in.pt")
    workers.run_ranks(workers.remat_rank, 2, tmp_path)
    for rank in range(2):
        off, on = workers.load(tmp_path, f"remat_out{rank}.pt")
        _assert_steps_equal(on, off)
        assert on["types"] == ["GlobalBatchNorm2d"]
