"""The protobuf wire codec of `analytics_zoo_tpu/onnx/`; `load_onnx`
(`onnx_loader.py`) is not ported yet (ROADMAP.md queue 1, item 8)."""

from analytics_zoo_tpu_torch.onnx import wire  # noqa: F401
