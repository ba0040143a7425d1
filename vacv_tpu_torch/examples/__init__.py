"""Runnable end-to-end examples of vacv_tpu_torch, on the card by default:
``python -m vacv_tpu_torch.examples.camera_tracking`` and
``python -m vacv_tpu_torch.examples.slam_frontend``."""
