"""The benchmark's seeded weights: the floating-point draws of the
published configurations are pinned by digest, and the program's integer
buffers (Swin's relative-position index) survive the draw."""

import hashlib
import json

import pytest
import torch

from conftest import BENCH, load_tiny
from harness import program, weights

CPU = torch.device("cpu")
SEED = 2 ** 31 + 5
# sha256 over the sorted floating-point keys and their bytes, drawn on the
# CPU from SEED: the draws as they were before integer entries were kept.
DIGESTS = {
    "kradar":
        "a0df0baf824237e1dc52627c8ab408f99f8ba17e0618bd55e94e6b88596881d2",
    "kradar_radar":
        "6ffe73c83806bbf4337ff64f8a67838cf0b272cffb94e376d1939007a73164c7",
}


def _state(config):
    from dpft_tpu_torch.models import dpft
    torch.manual_seed(0)
    return dpft.from_config(config).state_dict()


def _meta(state):
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in state.items()}


def _float_digest(drawn):
    h = hashlib.sha256()
    for key in sorted(drawn):
        if drawn[key].is_floating_point():
            h.update(key.encode())
            h.update(drawn[key].numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_float_draws_of_the_published_configs_are_pinned(name):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    template = _meta(_state(config))
    drawn = weights.draw(template, SEED, CPU)
    assert _float_digest(drawn) == DIGESTS[name]
    ints = [k for k, v in template.items() if not v.is_floating_point()]
    assert ints and all(k.endswith("num_batches_tracked") for k in ints)
    assert not any(drawn[k].any() for k in ints)


def test_integer_buffers_survive_the_draw():
    """Drawn from the program's own state dict, Swin's index buffers keep
    their values and ``num_batches_tracked`` is 0; drawn from the meta
    template, every integer entry is 0. The floating-point entries are the
    same either way, and the model that ``build_model`` returns holds the
    index it computed."""
    config = load_tiny("swin")
    state = _state(config)
    index = [k for k in state if k.endswith("relative_position_index")]
    assert len(index) == 2 + 2 + 6 + 2  # Swin-T's blocks
    counts = [k for k in state if k.endswith("num_batches_tracked")]
    state[counts[0]].fill_(7)
    real = weights.draw(state, SEED, CPU)
    meta = weights.draw(_meta(state), SEED, CPU)
    for key, value in state.items():
        if value.is_floating_point():
            assert torch.equal(real[key], meta[key]), key
        elif key in index:
            assert value.any() and torch.equal(real[key], value), key
            assert not meta[key].any(), key
        else:
            assert not real[key].any() and not meta[key].any(), key

    model, template = program.build_model(config, CPU, SEED)
    built = model.state_dict()
    for key in index:
        assert torch.equal(built[key], state[key]), key
        assert template[key].is_meta
