from mot3d_tpu_torch.data.detection_loader import DetectionSample  # noqa: F401
