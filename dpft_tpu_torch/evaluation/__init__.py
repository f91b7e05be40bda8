from dpft_tpu_torch.evaluation.evaluator import CentralizedEvaluator  # noqa: F401
