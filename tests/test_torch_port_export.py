"""The port's export path and FLOP count against the JAX package.

``dpft_tpu_torch/export.py`` freezes the eval forward with ``torch.export``
through the MSDA custom operators ``dpft::msda_fwd`` / ``dpft::msda_bwd``
(``ops/deform_attn.py``), and ``evaluation/evaluator.py:forward_flops``
counts a forward's FLOPs with ``FlopCounterMode``. On the CPU the operators
run the plain version; the CUDA kernels behind them run only on the card,
where ``chip_smoke.py`` holds the exported flagship against the eager one.

Held here, at the tiny config of test_full_model_parity with the JAX
variables carried across by ``state_dict_from_flax``: the operators pass
``torch.library.opcheck``; their gradients equal autograd through the plain
version bit for bit and JAX's core within the tolerance of
test_torch_port_msda_grad (1e-4: float32 sums in another order); JAX's
exported forward equals the port's saved and loaded program within rtol
1e-4 / atol 2e-4 (the bound of test_torch_port_model); a fresh interpreter
runs the artifact without the model code; export as a model's first call
leaves its eager forward as it was; the export CLI writes an artifact of
its ``--batch``; under ``fuser.pallas_msda: "mm"`` the model exports through
``dpft::msda_mm_fwd`` (its operators pass ``opcheck``, their gradients are
the plain hybrid's bits, the bins are sized from the shapes as the card's
launches size them) and equals the eager forward and JAX's export; the FLOP
count equals a reckoning by forward hooks (``chip_smoke.reckon_flops``)
exactly in every grad mode and under both MSDA backends, with no backend
switch, and ``Parameters`` equals JAX's ``parameter_count``. Exports are
few (each takes seconds): one per fixture, four in the file.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import _msda_nodes, reckon_flops
from dpft_tpu.export import export_forward as jax_export_forward
from dpft_tpu.models import build as jbuild
from dpft_tpu.ops.deform_attn import ms_deform_attn_core as jax_core
from dpft_tpu.utils.config import save_config
from dpft_tpu.utils.profiling import parameter_count as jax_parameter_count
from dpft_tpu_torch import export, prepare
from dpft_tpu_torch.evaluation import CentralizedEvaluator
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.ops import deform_attn as port
from kradar_fixture import base_config, make_raw_kradar
from test_full_model_parity import make_batch, tiny_config
from torch_port_common import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
KEYS = ("class", "center", "size", "angle")
SHAPES = ((6, 9), (3, 5), (2, 3), (1, 601))


def _core_inputs(D, B=2, N=7, H=4, P=4, seed=0):
    rng = np.random.default_rng(seed)
    L = len(SHAPES)
    Len = sum(h * w for h, w in SHAPES)
    value = rng.normal(size=(B, Len, H, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(B, N, H, L, P, 2)).astype(np.float32)
    att = rng.uniform(size=(B, N, H, L, P)).astype(np.float32)
    att /= att.reshape(B, N, H, -1).sum(-1).reshape(B, N, H, 1, 1)
    grad = rng.normal(size=(B, N, H * D)).astype(np.float32)
    return value, loc, att, grad


@pytest.fixture(scope="module")
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny(threads):
    """The tiny config in both packages on one set of JAX variables."""
    config = tiny_config()
    jmodel = jbuild("dprt", config)
    batch_np = make_batch(np.random.default_rng(0))
    variables = random_variables(
        jmodel, {k: jnp.asarray(v) for k, v in batch_np.items()},
        train=False, seed=1)
    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    return config, jmodel, variables, model, batch_np


@pytest.fixture(scope="module")
def artifact(tiny, tmp_path_factory):
    """The port's tiny model exported, saved and loaded."""
    _, _, _, model, batch_np = tiny
    path = str(tmp_path_factory.mktemp("port_export") / "tiny.pt2")
    program = export.export_forward(
        model, {k: torch.from_numpy(v) for k, v in batch_np.items()})
    export.save_exported(program, path)
    return path, program, export.load_exported(path)


@pytest.mark.parametrize("op", ["msda_fwd", "msda_bwd"])
def test_operators_pass_opcheck(op):
    value, loc, att, grad = map(torch.from_numpy, _core_inputs(3, seed=4))
    shapes = port._flat_shapes(SHAPES)
    if op == "msda_fwd":
        args = (value.requires_grad_(True), shapes, loc.requires_grad_(True),
                att.requires_grad_(True))
    else:
        args = (value, shapes, loc, att, grad)
    result = torch.library.opcheck(getattr(torch.ops.dpft, op), args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("D", [2, 3])
def test_operator_gradients_match_plain_bits_and_jax(D):
    value, loc, att, grad = _core_inputs(D, seed=D + 20)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (value, loc, att)]
    out = torch.ops.dpft.msda_fwd(leaves[0], port._flat_shapes(SHAPES),
                                  *leaves[1:])
    got = torch.autograd.grad(out, leaves, torch.from_numpy(grad))
    plain = [torch.from_numpy(a).requires_grad_(True)
             for a in (value, loc, att)]
    want = torch.autograd.grad(
        port.ms_deform_attn_core_plain(plain[0], SHAPES, *plain[1:]), plain,
        torch.from_numpy(grad))
    direct = torch.ops.dpft.msda_bwd(
        torch.from_numpy(value), port._flat_shapes(SHAPES),
        torch.from_numpy(loc), torch.from_numpy(att), torch.from_numpy(grad))
    _, vjp = jax.vjp(lambda v, l, a: jax_core(v, SHAPES, l, a),
                     *map(jnp.asarray, (value, loc, att)))
    for name, g, w, d, j in zip(("d_value", "d_loc", "d_att"), got, want,
                                direct, vjp(jnp.asarray(grad))):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(d, w, rtol=0, atol=0, msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=name,
                                   **GRAD_TOL)


def test_exported_program_matches_jax_export(tiny, artifact):
    config, jmodel, variables, model, batch_np = tiny
    _, program, loaded = artifact
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    want = jax_export_forward(jmodel, variables, batch).call(batch)
    got = loaded.module()({k: torch.from_numpy(v)
                           for k, v in batch_np.items()})
    got = {k: v.detach().numpy() for k, v in got.items()}
    for key in KEYS:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   err_msg=key, **TOL)
    fuser = config["model"]["fuser"]
    views_x_iterations = fuser["m_views"] * fuser["i_iter"]
    for graph in (program, loaded):
        assert _msda_nodes(graph) == \
            ["dpft.msda_fwd.default"] * views_x_iterations


def test_artifact_runs_without_the_model_code(tiny, artifact, tmp_path):
    _, _, _, model, _ = tiny
    path, _, _ = artifact
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(np.random.default_rng(5)).items()}
    torch.save(batch, tmp_path / "batch.pt")
    script = (
        "import sys, torch\n"
        "import dpft_tpu_torch.ops.deform_attn\n"
        "out = torch.export.load(sys.argv[1]).module()("
        "torch.load(sys.argv[2]))\n"
        "torch.save(out, sys.argv[3])\n"
        "assert not [m for m in sys.modules\n"
        "            if m.startswith('dpft_tpu_torch.models')], sys.modules\n")
    proc = subprocess.run(
        [sys.executable, "-c", script, path, str(tmp_path / "batch.pt"),
         str(tmp_path / "out.pt")], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = torch.load(tmp_path / "out.pt")
    with torch.inference_mode():
        want = model(batch)
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)


def test_export_as_first_call_leaves_eager_forward_unchanged(threads):
    config = tiny_config()
    fresh = registry.build("dprt", config, device="cpu", seed=3)
    twin = registry.build("dprt", config, device="cpu", seed=3)
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(np.random.default_rng(6)).items()}
    program = export.export_forward(fresh, batch)
    with torch.inference_mode():
        after, want = fresh(batch), twin(batch)
    got = program.module()(batch)
    for key in KEYS:
        torch.testing.assert_close(after[key], want[key], rtol=0, atol=0,
                                   msg=key)
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)


def test_matmul_form_exports_and_matches_eager_and_jax(tiny, tmp_path):
    """Under ``fuser.pallas_msda: "mm"`` the program holds one
    ``dpft.msda_mm_fwd`` node per view and iteration and no other MSDA
    node; saved and loaded it gives the eager forward's bits and JAX's
    exported forward under the same key (its fused matmul kernel in
    interpret mode) within the bound of test_torch_port_model."""
    import dpft_tpu.ops.deform_attn as jda

    config, _, variables, _, batch_np = tiny
    config = json.loads(json.dumps(config))
    config["model"]["fuser"]["pallas_msda"] = "mm"
    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    program = export.export_forward(model, batch)
    export.save_exported(program, str(tmp_path / "mm.pt2"))
    loaded = export.load_exported(str(tmp_path / "mm.pt2"))
    fuser = config["model"]["fuser"]
    for graph in (program, loaded):
        assert _msda_nodes(graph) == \
            ["dpft.msda_mm_fwd.default"] * (fuser["m_views"] * fuser["i_iter"])
    got = loaded.module()(batch)
    with torch.inference_mode():
        eager = model(batch)
    try:
        jmodel = jbuild("dprt", config)
        assert jda.get_msda_backend() == "pallas_mm"
        jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        want = jax_export_forward(jmodel, variables, jbatch).call(jbatch)
    finally:
        jda.set_msda_backend("xla")
    for key in KEYS:
        torch.testing.assert_close(got[key], eager[key], rtol=0, atol=0,
                                   msg=key)
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("op", ["msda_mm_fwd", "msda_mm_bwd"])
def test_matmul_form_operators_pass_opcheck(op):
    value, loc, att, grad = map(torch.from_numpy, _core_inputs(3, seed=6))
    shapes = port._flat_shapes(SHAPES)
    if op == "msda_mm_fwd":
        args = (value.requires_grad_(True), shapes, loc.requires_grad_(True),
                att.requires_grad_(True))
    else:
        _, xy, att_t, bins = torch.ops.dpft.msda_mm_fwd(value, shapes, loc,
                                                        att)
        args = (value, shapes, loc, att, xy, att_t, bins, grad)
    result = torch.library.opcheck(getattr(torch.ops.dpft, op), args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("D", [2, 3])
def test_matmul_form_gradients_match_plain_bits(D):
    """Autograd through ``dpft::msda_mm_fwd`` (whose backward is
    ``dpft::msda_mm_bwd``, the plain version recomputed on the CPU) gives
    the bits of autograd through ``ms_deform_attn_core_mm_plain``."""
    value, loc, att, grad = _core_inputs(D, seed=D + 30)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (value, loc, att)]
    out = port.ms_deform_attn_core(leaves[0], SHAPES, *leaves[1:],
                                   backend="mm")
    got = torch.autograd.grad(out, leaves, torch.from_numpy(grad))
    plain = [torch.from_numpy(a).requires_grad_(True)
             for a in (value, loc, att)]
    want = torch.autograd.grad(
        port.ms_deform_attn_core_mm_plain(plain[0], SHAPES, *plain[1:]),
        plain, torch.from_numpy(grad))
    for name, g, w in zip(("d_value", "d_loc", "d_att"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("shapes", [SHAPES, ((40, 50), (20, 25), (10, 13),
                                             (5, 7), (3, 4), (2, 2), (1, 1),
                                             (8, 9), (9, 9), (300, 301))])
def test_bin_lengths_from_shapes_equal_the_launch_tables(shapes):
    """The fake implementation sizes the bins from the shapes alone; the
    card's launches allocate them from ``mm_table``: the same lengths, one
    per launch of at most ``MM_MAX_LEVELS`` levels."""
    B, H, D, S = 2, 4, 3, 28
    mm, _ = port._split_levels(shapes)
    tables = port._group_tables(mm, B, sum(h * w for h, w in shapes), H, D,
                                S)
    assert port.mm_scratch_lengths(shapes, B * H, S) == \
        tuple(scratch for _, scratch in tables)
    assert len(tables) == -(-len(mm) // port.MM_MAX_LEVELS)


@pytest.fixture(scope="module")
def tree(tmp_path_factory, threads):
    """The mini K-Radar fixture prepared by the port, and a checkpoint of
    the tiny model with its config."""
    root = str(tmp_path_factory.mktemp("port_export_cli"))
    config = base_config()
    config["model"] = tiny_config()["model"]
    cfg = osp.join(root, "config.json")
    save_config(config, cfg)
    processed = osp.join(root, "processed")
    prepare.main(make_raw_kradar(root), cfg, processed, device="cpu")
    ckpt = osp.join(root, "run", "2026-01-01-00-00-00_checkpoint_0001.pt")
    registry.save(registry.build("dprt", config, device="cpu"), config, ckpt)
    return root, processed, cfg, ckpt


def test_export_cli_writes_an_artifact_of_its_batch_size(tree):
    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset
    from dpft_tpu_torch.evaluation.evaluator import to_device

    root, processed, cfg, ckpt = tree
    dst = osp.join(root, "model.pt2")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    export.main(processed, cfg, ckpt, dst, batch=2, device="cpu")
    assert not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
    program = export.load_exported(dst)
    inputs = {n.name: n.meta["val"].shape for n in program.graph.nodes
              if n.name in program.graph_signature.user_inputs}
    assert inputs and {shape[0] for shape in inputs.values()} == {2}

    model, config, _, _ = registry.load(ckpt, device="cpu")
    config = dict(config, train=dict(config["train"], batch_size=2))
    batch, _ = next(iter(load_dataset(
        init_dataset(config["dataset"], src=processed, split="test",
                     config=config), config=config, shuffle=False,
        pad_last=True)))
    batch = to_device(batch, torch.device("cpu"))
    got = program.module()(batch)
    with torch.inference_mode():
        want = model(batch)
    for key in KEYS:
        assert got[key].shape[0] == 2
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)


def test_export_cli_needs_the_card_by_default(tree):
    root, processed, cfg, ckpt = tree
    proc = subprocess.run(
        [sys.executable, "-m", "dpft_tpu_torch.export", "--src", processed,
         "--cfg", cfg, "--checkpoint", ckpt, "--dst",
         osp.join(root, "card.pt2"), "--batch", "1"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                           CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr
    assert not osp.exists(osp.join(root, "card.pt2"))


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
@pytest.mark.parametrize("backend", ["gather", "mm"])
def test_flop_count_equals_reckoning(tiny, mode, backend, monkeypatch):
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer

    config, jmodel, variables, model, batch_np = tiny
    if backend == "mm":
        config = json.loads(json.dumps(config))
        config["model"]["fuser"]["pallas_msda"] = "mm"
        model = registry.build("dprt", config, device="cpu")
        model.load_state_dict(state_dict_from_flax(variables, config),
                              strict=True)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    evaluator = CentralizedEvaluator(config=config, device="cpu")
    context = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
               "inference_mode": torch.inference_mode}[mode]
    seen = []    # the backend of every MSDA call while counting

    def core(*args, backend):
        seen.append(backend)
        return port.ms_deform_attn_core(*args, backend=backend)

    monkeypatch.setattr(msda_layer, "ms_deform_attn_core", core)
    with context():
        got = evaluator.evaluate_complexity(model, [(batch_np, {})])
    fuser = config["model"]["fuser"]
    assert seen == [backend] * (fuser["m_views"] * fuser["i_iter"])
    assert got["FLOPS"] == reckon_flops(model, batch)
    assert got["Parameters"] == jax_parameter_count(variables["params"])
    # The count changes nothing: the gradients and the backend are back.
    assert all(p.requires_grad for p in model.parameters())
    assert {m.backend for m in model.modules() if hasattr(m, "backend")} == \
        {backend}
