from dpft_tpu_torch.models.heads.detection import (  # noqa: F401
    LinearDetectionHead, UnaryDetectionHead, build_detection_head,
)
