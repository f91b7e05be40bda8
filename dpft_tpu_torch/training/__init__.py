from dpft_tpu_torch.training.trainer import CentralizedTrainer  # noqa: F401
