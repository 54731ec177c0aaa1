"""PyTorch/CUDA port of ``yolo_ms_tpu`` for NVIDIA Hopper (H100).

The serving path (uint8 NHWC batch -> normalize -> BN-folded forward ->
fused post-process with the hand-written CUDA ``select`` kernel -> NMS ->
Predictor) mirrors the JAX package module for module. This package imports
torch, numpy, cv2 and the standard library only; it never imports jax, flax
or ``yolo_ms_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
