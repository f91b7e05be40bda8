"""Model zoo: build from a config, checkpoint IO and the weight bridge."""

from dpft_tpu_torch.models.registry import build, load, save  # noqa: F401
