"""The port's matmul-form MSDA path against the JAX package's.

dpft_tpu_torch/ops/deform_attn.py: the plain level op
(``sample_level_fused`` on CPU tensors, the plain PyTorch version of the
CUDA kernels csrc/msda_mm.cu) is held against the TPU kernel
``sample_level_fused`` of dpft_tpu/ops/pallas/deform_attn_mm.py in
interpret mode, as its own tests run it on the CPU: forward within 1e-5,
the gradients of val, x, y and att against its custom VJP within 1e-4
(float32 sums in another order), also with points on exactly integer
coordinates (where the kernel's derivative is 0) and at +-1e9 (which add
nothing). ``ms_deform_attn_core(backend="mm")`` is held against the
per-element reference, the JAX core under ``pallas_mm`` and the port's
gather backend; the last level (1, 601) takes the gather branch on both
sides. bfloat16 within 2e-2 (bfloat16 rounding at other places).

The CUDA kernels run only on the card, where chip_smoke.py holds them
against these plain versions. What surrounds them on the card, the layout
code of the card implementations of the operators ``dpft::msda_mm_fwd`` /
``dpft::msda_mm_bwd``, is run here with the four kernel wrappers replaced
by their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dpft_tpu.ops.deform_attn as jda
from dpft_tpu.ops.pallas.deform_attn_mm import \
    sample_level_fused as jax_fused
from dpft_tpu_torch.models.fusers import mpfusion
from dpft_tpu_torch.models.heads.detection import build_detection_head
from dpft_tpu_torch.ops import deform_attn as port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SHAPES = ((6, 9), (3, 5), (2, 3), (1, 601))
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LEVEL = dict(BH=3, h=7, w=5, S=150)


@pytest.fixture
def pallas_mm_backend():
    """The JAX core under its fused matmul kernel. The switch is a process
    global read at trace time: it is set back whatever happens."""
    jda.set_msda_backend("pallas_mm")
    yield
    jda.set_msda_backend("xla")


def _level_inputs(D, case="random", BH=3, h=7, w=5, S=150, seed=0):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(BH, h, w * D)).astype(np.float32)
    x = rng.uniform(-2, w + 2, size=(BH, S)).astype(np.float32)
    y = rng.uniform(-2, h + 2, size=(BH, S)).astype(np.float32)
    att = rng.uniform(size=(BH, S)).astype(np.float32)
    grad = rng.normal(size=(BH, S, D)).astype(np.float32)
    if case == "integer":
        # A third of the points on integer x, a third on integer y (some on
        # both), inside the map and on its border lines -1 and size.
        x[:, ::3] = rng.integers(-1, w + 1, size=x[:, ::3].shape)
        y[:, 1::3] = rng.integers(-1, h + 1, size=y[:, 1::3].shape)
        y[:, ::6] = rng.integers(-1, h + 1, size=y[:, ::6].shape)
    elif case == "far":
        x[:, :40] = 1e9
        y[:, 20:60] = -1e9
    return val, x, y, att, grad


def _port_level(val, x, y, att, grad, h, w, dtype=torch.float32):
    args = [torch.from_numpy(a).requires_grad_(True) for a in (val, x, y, att)]
    out = port.sample_level_fused(args[0].to(dtype), args[1], args[2],
                                  args[3].to(dtype), h, w)
    out.float().backward(torch.from_numpy(grad))
    return out.detach().float().numpy(), [a.grad.numpy() for a in args]


def _jax_level(val, x, y, att, grad, h, w):
    out, vjp = jax.vjp(lambda v, xx, yy, aa: jax_fused(v, xx, yy, aa, h, w),
                       *map(jnp.asarray, (val, x, y, att)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(grad))]


@pytest.mark.parametrize("case", ["random", "integer", "far"])
@pytest.mark.parametrize("D", [4, 2])
def test_level_op_matches_jax_fused_kernel(D, case):
    """Forward and all four gradients; D=4 / random is the case of
    test_pallas_deform_attn_mm.py:test_level_op_padding_and_tiles."""
    h, w = LEVEL["h"], LEVEL["w"]
    inputs = _level_inputs(D, case, seed=D)
    got, got_grads = _port_level(*inputs, h, w)
    want, want_grads = _jax_level(*inputs, h, w)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for name, g, wg in zip(("d_val", "d_x", "d_y", "d_att"), got_grads,
                           want_grads):
        assert g.shape == wg.shape, name
        np.testing.assert_allclose(g, wg, err_msg=name, **GRAD_TOL)
    if case == "far":
        x, y = inputs[1], inputs[2]
        far = (np.abs(x) > 1e8) | (np.abs(y) > 1e8)
        assert far.any() and np.all(got[far] == 0)
        for g in got_grads[1:]:
            assert np.all(g[far] == 0)
    if case == "integer":
        # On an integer coordinate the tap at distance 0 has derivative 0
        # and its neighbours weight 0: no gradient along that axis.
        x, y = inputs[1], inputs[2]
        assert np.all(got_grads[1][x == np.round(x)] == 0)
        assert np.all(got_grads[2][y == np.round(y)] == 0)
        assert (got_grads[1] != 0).any() and (got_grads[2] != 0).any()


@pytest.mark.parametrize("D", [4, 2])
def test_level_op_bf16_matches_jax_fused_bf16(D):
    h, w = LEVEL["h"], LEVEL["w"]
    val, x, y, att, grad = _level_inputs(D, seed=10 + D)
    got, _ = _port_level(val, x, y, att, grad, h, w, dtype=torch.bfloat16)
    want = jax_fused(jnp.asarray(val, jnp.bfloat16), jnp.asarray(x),
                     jnp.asarray(y), jnp.asarray(att, jnp.bfloat16), h, w)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def _core_inputs(D, B=2, N=7, H=4, P=4, shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    Len = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, Len, H, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(B, N, H, L, P, 2)).astype(np.float32)
    att = rng.uniform(size=(B, N, H, L, P)).astype(np.float32)
    att /= att.reshape(B, N, H, -1).sum(-1).reshape(B, N, H, 1, 1)
    grad = rng.normal(size=(B, N, H * D)).astype(np.float32)
    return value, loc, att, grad


def _port_core(fn, value, loc, att, grad, shapes=SHAPES, **kwargs):
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (value, loc, att)]
    out = fn(args[0], shapes, args[1], args[2], **kwargs)
    out.backward(torch.from_numpy(grad))
    return out.detach().numpy(), [a.grad.numpy() for a in args]


@pytest.mark.parametrize("D", [2, 3])
def test_mm_core_matches_naive_reference(D):
    value, loc, att, grad = _core_inputs(D, seed=D)
    got, _ = _port_core(port.ms_deform_attn_core, value, loc, att, grad,
                        backend="mm")
    want = np.asarray(jda.ms_deform_attn_core_naive(value, SHAPES, loc, att))
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("D", [2, 3])
def test_mm_core_matches_jax_pallas_mm(D, pallas_mm_backend):
    value, loc, att, grad = _core_inputs(D, seed=10 + D)
    got, got_grads = _port_core(port.ms_deform_attn_core, value, loc, att,
                                grad, backend="mm")
    want, vjp = jax.vjp(
        lambda v, l, a: jda.ms_deform_attn_core(v, SHAPES, l, a),
        *map(jnp.asarray, (value, loc, att)))
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)
    for name, g, wg in zip(("d_value", "d_loc", "d_att"), got_grads,
                           vjp(jnp.asarray(grad))):
        np.testing.assert_allclose(g, np.asarray(wg), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("D", [2, 3])
def test_mm_core_matches_gather_core(D):
    """Continuous locations: off the integer coordinates the two forms have
    the same derivative."""
    inputs = _core_inputs(D, seed=20 + D)
    got, got_grads = _port_core(port.ms_deform_attn_core, *inputs,
                                backend="mm")
    want, want_grads = _port_core(port.ms_deform_attn_core, *inputs,
                                  backend="gather")
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for name, g, wg in zip(("d_value", "d_loc", "d_att"), got_grads,
                           want_grads):
        np.testing.assert_allclose(g, wg, err_msg=name, **GRAD_TOL)


def test_core_rejects_unknown_backend():
    value, loc, att, _ = _core_inputs(2)
    with pytest.raises(ValueError, match="backend"):
        port.ms_deform_attn_core(torch.from_numpy(value), SHAPES,
                                 torch.from_numpy(loc), torch.from_numpy(att),
                                 backend="pallas")


def test_mm_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: on CPU tensors the wrappers raise and launch nothing."""
    h, w = LEVEL["h"], LEVEL["w"]
    val, x, y, att, grad = map(torch.from_numpy, _level_inputs(2))
    before = (port.msda_mm_fwd.launches, port.msda_mm_bwd.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.msda_mm_fwd(val, x, y, att, h, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.msda_mm_bwd(val, x, y, att, grad, h, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.SampleLevelMMFunction.apply(val, x, y, att, h, w)
    assert (port.msda_mm_fwd.launches, port.msda_mm_bwd.launches) == before


def test_mm_dispatch_takes_plain_on_cpu():
    inputs = _core_inputs(3, seed=5)
    before = [f.launches for f in (port.msda_fwd, port.msda_bwd,
                                   port.msda_mm_fwd, port.msda_mm_bwd)]
    got, got_grads = _port_core(port.ms_deform_attn_core, *inputs,
                                backend="mm")
    want, want_grads = _port_core(port.ms_deform_attn_core_mm_plain, *inputs)
    np.testing.assert_array_equal(got, want)
    for g, wg in zip(got_grads, want_grads):
        np.testing.assert_array_equal(g, wg)
    assert [f.launches for f in (port.msda_fwd, port.msda_bwd,
                                 port.msda_mm_fwd, port.msda_mm_bwd)] == before


def test_val_layout_of_contiguous_and_in_place_levels():
    """The strides handed to the kernels: a (BH, h, w*D) array, and one
    level of a (B, Len, H, D) tensor read in place."""
    B, H, D, h, w = 2, 4, 3, 5, 7
    BH, dim, layout = port._val_layout("t", torch.zeros(B * H, h, w * D), h,
                                       w)
    assert (BH, dim, list(layout)) == (8, 3, [1, h * w * D, 0, w * D, D])
    value = torch.zeros(B, 11 + h * w, H, D)
    view = port._level_view(value, 11, h, w)
    assert view.shape == (B, H, h, w, D)
    assert view.data_ptr() == value[:, 11:].data_ptr()
    BH, dim, layout = port._val_layout("t", view, h, w)
    assert (BH, dim, list(layout)) == (8, 3, [H, (11 + h * w) * H * D, D,
                                              w * H * D, H * D])
    with pytest.raises(ValueError, match="val"):
        port._val_layout("t", torch.zeros(8, h + 1, w * D), h, w)
    with pytest.raises(ValueError, match="val"):
        port._val_layout("t", view.transpose(3, 4), h, w)


BINS = "the bins of the forward's launch"


def _card_core(value, shapes, loc, att):
    """The card implementations of ``dpft::msda_mm_fwd`` and
    ``dpft::msda_mm_bwd`` as one differentiable function, the forward's
    xy, att_t and bins handed to the backward as the operator's autograd
    hands them."""
    class Card(torch.autograd.Function):
        @staticmethod
        def forward(ctx, value, loc, att):
            out, xy, att_t, ctx.bins = port._msda_mm_fwd_card(value, shapes,
                                                              loc, att)
            ctx.save_for_backward(value, loc, att, xy, att_t)
            return out

        @staticmethod
        def backward(ctx, grad_out):
            value, loc, att, xy, att_t = ctx.saved_tensors
            return port._msda_mm_bwd_card(value, shapes, loc, att, xy, att_t,
                                          ctx.bins, grad_out)

    return Card.apply(value, loc, att)


def _emulated_kernels(monkeypatch):
    """The kernel wrappers (per level, grouped, and kernel #1) computed by
    their plain versions on the tensors they are given, outputs written
    where the kernels write them. A grouped call counts as one launch."""
    def level(val):
        B, H, h, w, D = val.shape
        return val.reshape(B * H, h, w * D)

    def mm_fwd(val, x, y, att, h, w, out=None):
        port.msda_mm_fwd.launches += 1
        got = port.sample_level_fused_plain(level(val), x, y, att, h, w)
        return got if out is None else out.copy_(got)

    def mm_bwd(val, x, y, att, grad_out, h, w, out=None):
        port.msda_mm_bwd.launches += 1
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True)
                    for t in (level(val), x, y, att)]
            res = port.sample_level_fused_plain(*args, h, w)
            grads = torch.autograd.grad(res, args, grad_out)
        for dst, g in zip(out, grads):
            dst.copy_(g.reshape(dst.shape))
        return out

    def mm_fwd_group(value, levels, loc, att, sizes, xy, att_t, out):
        assert value.is_contiguous() and out.shape[0] == len(levels)
        made = port.mm_coords_plain(loc, att, sizes)   # the launch fills them
        xy.copy_(made[0])
        att_t.copy_(made[1])
        for k, (lvl, start, h, w) in enumerate(levels):
            mm_fwd(port._level_view(value, start, h, w), xy[lvl, 0],
                   xy[lvl, 1], att_t[lvl], h, w, out=out[k])
        port.msda_mm_fwd.launches -= len(levels) - 1
        return [BINS]

    def mm_bwd_group(value, levels, xy, att_t, grad_out, bins, out):
        assert bins == [BINS]          # the forward's bins come back
        d_value, d_xy, d_att_t = out
        for lvl, start, h, w in levels:
            mm_bwd(port._level_view(value, start, h, w), xy[lvl, 0],
                   xy[lvl, 1], att_t[lvl], grad_out, h, w,
                   out=(port._level_view(d_value, start, h, w), d_xy[lvl, 0],
                        d_xy[lvl, 1], d_att_t[lvl]))
        port.msda_mm_bwd.launches -= len(levels) - 1
        return out

    def fwd(value, shapes, loc, att):
        port.msda_fwd.launches += 1
        assert all(t.is_contiguous() for t in (value, loc, att))
        return port.ms_deform_attn_core_plain(value, shapes, loc, att)

    def bwd(value, shapes, loc, att, grad_out):
        port.msda_bwd.launches += 1
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True)
                    for t in (value, loc, att)]
            res = port.ms_deform_attn_core_plain(args[0], shapes, *args[1:])
            return torch.autograd.grad(res, args, grad_out)

    for name, fn in (("msda_mm_fwd", mm_fwd), ("msda_mm_bwd", mm_bwd),
                     ("msda_fwd", fwd), ("msda_bwd", bwd)):
        fn.launches = 0
        monkeypatch.setattr(port, name, fn)
    monkeypatch.setattr(port, "msda_mm_fwd_group", mm_fwd_group)
    monkeypatch.setattr(port, "msda_mm_bwd_group", mm_bwd_group)


@pytest.mark.parametrize("shapes", [SHAPES, ((1, 601), (4, 3), (300, 301),
                                             (2, 2))])
def test_card_path_layout_with_emulated_kernels(monkeypatch, shapes):
    """The card implementations of the ``"mm"`` operators (what a CUDA
    tensor takes) with their kernels emulated: their shuffles, in-place
    level views and gradient assembly
    give the plain hybrid's outputs and gradients, level by level, with
    one launch per direction for all matmul levels of the call and one of
    kernel #1 per level above the cutoff."""
    _emulated_kernels(monkeypatch)
    inputs = _core_inputs(3, shapes=shapes, seed=7)
    got, got_grads = _port_core(_card_core, *inputs,
                                shapes=shapes)
    n_gather = sum(h + w > port._MATMUL_MAX_HW for h, w in shapes)
    n_mm = len(shapes) - n_gather
    assert n_gather and n_mm
    assert [f.launches for f in (port.msda_mm_fwd, port.msda_mm_bwd,
                                 port.msda_fwd, port.msda_bwd)] == [
        1, 1, n_gather, n_gather]
    want, want_grads = _port_core(port.ms_deform_attn_core_mm_plain, *inputs,
                                  shapes=shapes)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for name, g, wg in zip(("d_value", "d_loc", "d_att"), got_grads,
                           want_grads):
        np.testing.assert_allclose(g, wg, rtol=1e-5, atol=1e-6, err_msg=name)


FUSER = {"i_iter": 2, "m_views": 2, "d_model": 16, "d_ffn": 32,
         "n_queries": 6, "n_levels": [2, 2], "n_heads": [2, 2],
         "n_points": [2, 2]}
HEAD = {"in_channels": 16, "num_classes": 2}


def _fuser(**extra):
    return mpfusion.build_mpfusion({**FUSER, **extra},
                                   build_detection_head(
                                       "linear_detection_head", HEAD))


@pytest.mark.parametrize("key,backend", [
    ({"pallas_msda": "mm"}, "mm"), ({}, "gather"),
    ({"pallas_msda": False}, "gather"), ({"pallas_msda": True}, "gather"),
    ({"pallas_msda": "gather"}, None)])
def test_build_mpfusion_reads_pallas_msda(key, backend):
    if backend is None:
        with pytest.raises(ValueError, match="pallas_msda"):
            _fuser(**key)
        return
    fuser = _fuser(**key)
    layers = [m for m in fuser.modules()
              if isinstance(m, mpfusion.MSDeformAttn)]
    assert len(layers) == 4 and {m.backend for m in layers} == {backend}
    # The backend is no parameter and no buffer.
    assert list(fuser.state_dict()) == list(_fuser().state_dict())
