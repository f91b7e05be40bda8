"""Shifted-window attention of the Swin blocks (``dpft_tpu_torch/ops/
window_attn.py``, ``models/backbones/swin.py``).

On the CPU:

- ``dpft::window_attn_fwd`` (its CPU implementation, the plain version)
  and the port's Swin block against ``tests/torch_refs.py``'s
  transliteration of torchvision's ``shifted_window_attention``, within
  1e-5 of the largest output element: both axes shifted, the shift off
  along one axis, padding on both axes, B = 1 and 2, 2 to 4 heads of
  width 32;
- which path a block takes under grad, ``no_grad`` and ``inference_mode``,
  on the card (float32 and bfloat16) and on the CPU, and under
  ``torch.export``; the counters
  ``dpft.window_attn.fused`` and ``.plain``, and a replayed stage counting
  the fused calls of its capture again (the capture emulated on the CPU);
- ``torch.export`` of a tiny Swin DPFT through the operator's fake
  implementation, and its FLOP formula;
- built under ``torch.device("meta")`` every Swin buffer lies on meta; the
  relative-position index is torchvision's;
- the stage spans, under a DPFT model's backbone span and on a bare trunk.

On the card (``card``: skipped without one; run there with
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_port_window_attn.py``, this file imports no JAX): the
kernel against a float64 computation at the four stage shapes of the
Swin-B camera at 512x910, within 1e-5 of the largest output element (a
TF32 product would read about 1e-3); with bfloat16 qkv, against the same
computation on the bfloat16 values within 2 ** -8 (the output's rounding
to bfloat16); captured and replayed as a stage, the
bit-equal output, with ``dpft.window_attn.fused`` advancing per replay.
"""

import contextlib
import json
import os.path as osp
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_refs
from dpft_tpu_torch.models import dpft, graphs
from dpft_tpu_torch.models.backbones import swin
from dpft_tpu_torch.models.layers.common import init_parameters
from dpft_tpu_torch.ops import window_attn
from dpft_tpu_torch.utils import profiling

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY_SWIN = osp.join(ROOT, "h100_bench", "tests", "tiny_kradar_swin.json")
TOL = 1e-5
# (H, W, heads, shift, B): both axes shifted; padding on both axes; the
# shift off along the height (one window covers its padded 7 rows); off
# along the width; a map one window covers (no shift).
CASES = [(14, 21, 2, 3, 1), (9, 12, 3, 3, 2), (5, 16, 4, 3, 2),
         (17, 6, 2, 3, 1), (7, 7, 3, 3, 2)]
# The Swin-B camera's stages at 512x910: (H, W, C, heads).
SWIN_B_STAGES = [(128, 227, 128, 4), (64, 114, 256, 8), (32, 57, 512, 16),
                 (16, 29, 1024, 32)]


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def pair(dim, heads, shift, seed=0):
    """The reference module and the port's block with its weights."""
    torch.manual_seed(seed)
    ref = torch_refs.TorchShiftedWindowAttention(dim, [7, 7], [shift, shift],
                                                 heads)
    with torch.no_grad():
        ref.relative_position_bias_table.normal_(0, 0.5)
    state = ref.state_dict()
    state["relative_position_index"] = state[
        "relative_position_index"].reshape(-1)
    port = swin.ShiftedWindowAttention(dim, heads, shift)
    port.load_state_dict(state)
    return ref, port


def close(got, want):
    scale = want.abs().max().item()
    gap = (got.double() - want.double()).abs().max().item()
    assert gap <= TOL * scale, (gap, scale)


def effective_shift(Hp, Wp, shift):
    return (shift if Hp > 7 else 0, shift if Wp > 7 else 0)


def padded(x):
    H, W = x.shape[1], x.shape[2]
    return F.pad(x, (0, 0, 0, -W % 7, 0, -H % 7))


@pytest.mark.parametrize("H,W,heads,shift,B", CASES)
def test_op_and_block_match_torchvision(H, W, heads, shift, B):
    C = 32 * heads
    ref, port = pair(C, heads, shift)
    x = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref(x)
        xp = padded(x)
        qkv = port.qkv(xp)
        out = torch.ops.dpft.window_attn_fwd(
            qkv, port.relative_position_bias_table,
            port.relative_position_index, heads,
            *effective_shift(xp.shape[1], xp.shape[2], shift))
        close(port.proj(out)[:, :H, :W], want)
        close(port(x), want)
    close(port(x), want)   # grad on: the training path


def test_plain_version_takes_a_mask_or_makes_it():
    qkv = torch.randn(2, 14, 21, 3 * 64)
    table = torch.randn(169, 2)
    index = swin.relative_position_index(7)
    mask = window_attn.shift_mask(14, 21, 7, (3, 3))
    torch.testing.assert_close(
        window_attn.window_attention_plain(qkv, table, index, 2, (3, 3)),
        window_attn.window_attention_plain(qkv, table, index, 2, (3, 3),
                                           mask), rtol=0, atol=0)


@pytest.mark.parametrize("cuda", [True, False])
def test_the_path_by_grad_mode_and_device(cuda):
    qkv = types.SimpleNamespace(dtype=torch.float32, is_cuda=cuda)
    assert not swin.fused(qkv)
    with torch.no_grad():
        assert swin.fused(qkv) == cuda
        assert swin.fused(types.SimpleNamespace(dtype=torch.bfloat16,
                                                is_cuda=cuda)) == cuda
    with torch.inference_mode():
        assert swin.fused(qkv) == cuda
    with torch.enable_grad():
        assert not swin.fused(qkv)


def window_counters():
    return {k: v for k, v in profiling.counters().items()
            if k.startswith("dpft.window_attn.")}


def profiled():
    """A CPU profiler window whose session starts afresh (a session ends
    when the main thread finds the profiler off)."""
    from torch.profiler import ProfilerActivity, profile

    profiling.enabled()
    return profile(activities=[ProfilerActivity.CPU])


def test_counters_count_each_block_call():
    _, port = pair(64, 2, 3)
    x = torch.randn(1, 14, 14, 64)
    port(x)   # no profiler: nothing counts
    with profiled():
        port(x)
        with torch.no_grad():
            port(x)
        with torch.inference_mode():
            port(x)
    assert window_counters() == {profiling.WINDOW_ATTN_PLAIN: 3}


@contextlib.contextmanager
def fused_on_cpu():
    """Blocks take the operator on the CPU too (its plain version)."""
    saved = swin.fused
    swin.fused = lambda qkv: not torch.is_grad_enabled()
    try:
        yield
    finally:
        swin.fused = saved


def test_a_replay_counts_the_fused_calls_of_its_capture(monkeypatch):
    from test_torch_port_graphs import _Emulated

    def captured_run(run):
        result = run()
        return _Emulated(run, result), result

    def capture(forward, module, args, kwargs, spec, tensors):
        out = forward(module, *args, **kwargs)
        return out, graphs._record(forward, module, spec, tensors)

    monkeypatch.setattr(graphs, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_captured", captured_run)
    monkeypatch.setattr(graphs, "_capture", capture)
    backbone = swin.SwinBackbone("swin_t", 3, 2).eval()
    blocks = 2 + 2
    x = torch.randn(1, 3, 64, 64)
    with fused_on_cpu(), torch.inference_mode():
        want = backbone(x)
        backbone(x)                                  # captures
        with profiled():
            for _ in range(3):
                got = backbone(x)                    # replays
    assert profiling.counters()[profiling.GRAPH_REPLAYS] == 3
    assert window_counters() == {profiling.WINDOW_ATTN_FUSED: 3 * blocks}
    for k in want:
        assert torch.equal(got[k], want[k])


def test_stage_spans_inside_a_dpft_model():
    model, batch = tiny_swin_dpft()
    with profiled():
        with torch.no_grad():
            model(batch)
    spans = profiling.span_totals()
    for s in range(1, 5):
        assert spans[f"dpft.frontend.view0.backbone.stage{s}"]["calls"] == 1
    assert window_counters() == {profiling.WINDOW_ATTN_PLAIN: 12}


def test_stage_spans_of_a_bare_trunk():
    backbone = swin.SwinBackbone("swin_t", 3, 2).eval()
    x = torch.randn(1, 3, 64, 64)
    with profiled():
        with torch.no_grad():
            backbone(x)
        with profiling.span("outer"):
            backbone(x)
    spans = profiling.span_totals()
    assert {name for name in spans if "stage" in name} == {
        "stage1", "stage2", "outer.stage1", "outer.stage2"}


def test_plain_version_of_bfloat16_qkv_returns_bfloat16():
    qkv = torch.randn(1, 14, 14, 3 * 64)
    table = torch.randn(169, 2)
    index = swin.relative_position_index(7)
    got = torch.ops.dpft.window_attn_fwd(qkv.bfloat16(), table, index, 2,
                                         3, 3)
    assert got.dtype == torch.bfloat16
    want = window_attn.window_attention_plain(qkv.bfloat16().float(), table,
                                              index, 2, (3, 3))
    assert (got.float() - want).abs().max() <= 2 ** -7 * want.abs().max()


def tiny_swin_dpft():
    from dpft_tpu_torch.evaluation.evaluator import to_device
    from test_full_model_parity import make_batch

    with open(TINY_SWIN) as f:
        config = json.load(f)
    model = dpft.from_config(config)
    model = init_parameters(model, torch.Generator().manual_seed(0)).eval()
    batch = to_device(make_batch(np.random.default_rng(0)),
                      torch.device("cpu"))
    return model, {k: v[:1] for k, v in batch.items()}


def test_export_of_a_swin_dpft_holds_the_operator():
    model, batch = tiny_swin_dpft()
    with torch.no_grad():
        want = model(batch)
        program = torch.export.export(model, (batch,), strict=False)
    # The forward's autocast region is a subgraph of its own.
    nodes = [n for gm in program.graph_module.modules()
             if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
             if n.target is torch.ops.dpft.window_attn_fwd.default]
    assert len(nodes) == 2 + 2 + 6 + 2     # Swin-T's blocks
    with torch.no_grad():
        got = program.module()(batch)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=TOL * want[k].abs().max().item())


def test_flop_formula_counts_both_products():
    qkv = torch.randn(2, 14, 21, 3 * 96)
    with torch.utils.flop_counter.FlopCounterMode(display=False) as counter:
        torch.ops.dpft.window_attn_fwd(qkv, torch.randn(169, 3),
                                       swin.relative_position_index(7), 3,
                                       3, 3)
    assert counter.get_total_flops() == 2 * 2 * 2 * 14 * 21 * 49 * 96


def test_buffers_of_a_model_built_on_meta_stay_there():
    with torch.device("meta"):
        backbone = swin.SwinBackbone("swin_t", 6, 4)
    buffers = dict(backbone.named_buffers())
    assert len(buffers) == 12
    assert {t.device.type for t in buffers.values()} == {"meta"}
    # torchvision's index, as numpy made it before.
    coords = np.stack(np.meshgrid(np.arange(7), np.arange(7), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + 6
    np.testing.assert_array_equal(
        swin.relative_position_index(7).numpy(),
        (rel[..., 0] * 13 + rel[..., 1]).reshape(-1))


# -- on the card ----------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("H,W,C,heads", SWIN_B_STAGES)
@pytest.mark.parametrize("shift", [0, 3])
def test_kernel_against_float64_at_the_swin_b_stages(card, H, W, C, heads,
                                                     shift):
    gen = torch.Generator(card).manual_seed(H * 1000 + shift)
    Hp, Wp = -(-H // 7) * 7, -(-W // 7) * 7
    qkv = torch.randn(1, Hp, Wp, 3 * C, device=card, generator=gen)
    table = torch.randn(169, heads, device=card, generator=gen)
    index = swin.relative_position_index(7).to(card)
    before = window_attn.window_attn_fwd.launches
    got = torch.ops.dpft.window_attn_fwd(qkv, table, index, heads, shift,
                                         shift)
    torch.cuda.synchronize(card)
    assert window_attn.window_attn_fwd.launches == before + 1
    want = window_attn.window_attention_plain(
        qkv.double(), table.double(), index, heads, (shift, shift))
    close(got, want)


@pytest.mark.card
@pytest.mark.parametrize("H,W,C,heads", SWIN_B_STAGES)
@pytest.mark.parametrize("shift", [0, 3])
def test_bfloat16_kernel_at_the_swin_b_stages(card, H, W, C, heads, shift):
    gen = torch.Generator(card).manual_seed(H * 1000 + shift + 1)
    Hp, Wp = -(-H // 7) * 7, -(-W // 7) * 7
    qkv = torch.randn(1, Hp, Wp, 3 * C, device=card,
                      generator=gen).bfloat16()
    table = torch.randn(169, heads, device=card, generator=gen)
    index = swin.relative_position_index(7).to(card)
    got = torch.ops.dpft.window_attn_fwd(qkv, table, index, heads, shift,
                                         shift)
    assert got.dtype == torch.bfloat16
    want = window_attn.window_attention_plain(
        qkv.double(), table.double(), index, heads, (shift, shift))
    scale = want.abs().max().item()
    gap = (got.double() - want).abs().max().item()
    assert gap <= 2 ** -8 * scale, (gap, scale)


@pytest.mark.card
def test_kernel_replayed_in_a_stage_gives_the_same_bits(card):
    from torch.profiler import ProfilerActivity, profile

    profiling.enabled()   # this window's counters start at 0
    with torch.device(card):
        backbone = swin.SwinBackbone("swin_t", 3, 2).eval()
    assert {t.device for t in backbone.buffers()} == {card}
    x = torch.randn(1, 3, 128, 224, device=card)
    blocks = 2 + 2
    with torch.inference_mode():
        want = backbone(x)
        backbone(x)                                  # captures
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in range(2):
                got = backbone(x)
            torch.cuda.synchronize(card)
    assert profiling.counters()[profiling.GRAPH_REPLAYS] == 2
    assert window_counters() == {profiling.WINDOW_ATTN_FUSED: 2 * blocks}
    for k in want:
        assert torch.equal(got[k], want[k])
    with torch.enable_grad():
        plain = backbone(x)
    for k in want:
        close(want[k], plain[k].detach())
