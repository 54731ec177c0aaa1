"""The serving function as one module, and the loader of its exported program.

``ServingProgram`` is the ``serve`` function of
``yolo_ms_tpu/tools/export.py:export_stablehlo``: uint8 NHWC pixels ->
normalize -> forward (split head) -> ``fused_postprocess`` -> the detection
dict. ``Predictor.infer`` runs it eagerly;
``tools/export.py:export_program`` traces it with ``torch.export`` into a
file that holds the weights, the graph and the calls of the ``select`` and
``nms_fixed`` ops.

``load_program`` serves such a file without the model code: it imports only
the modules that register the ``select`` and ``nms_fixed`` ops (and build
their kernels at first use on the card), never a
``yolo_ms_tpu_torch.models`` module.
"""

from __future__ import annotations

import torch
from torch import nn

from yolo_ms_tpu_torch.data.augment import device_normalize_images
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess
from yolo_ms_tpu_torch.utils.device import resolve_device
from yolo_ms_tpu_torch.utils.profiler import span


class ServingProgram(nn.Module):
    """A model in eval mode (BN-folded, or not under ``Predictor(deploy=
    False)``) and the post-process settings.

    ``forward(images_u8)``: [B, H, W, 3] uint8 on the model's device ->
    {'boxes' [B, max_det, 4] xyxy f32 px, 'scores' [B, max_det] f32,
    'classes' [B, max_det] i32, 'valid' [B, max_det] bool}. The network runs
    in ``dtype`` on NCHW-shaped tensors whose memory is ``memory_format``:
    contiguous NCHW by default, ``torch.channels_last`` once
    ``infer/layouts.py:AutoLayoutInfer`` has converted the weights. The
    post-process reads NHWC views of the head's maps in place: strided in
    the default layout, contiguous in channels-last. No grad or precision
    context is set here: the caller chooses.
    """

    memory_format = torch.contiguous_format

    def __init__(
        self,
        model: nn.Module,
        num_classes: int,
        reg_max: int = 16,
        conf_thresh: float = 0.25,
        iou_thresh: float = 0.45,
        max_det: int = 300,
        pre_nms_topk: int = 1024,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.model = model
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.conf_thresh = conf_thresh
        self.iou_thresh = iou_thresh
        self.max_det = max_det
        self.pre_nms_topk = pre_nms_topk
        self.dtype = dtype

    def network_input(self, images_u8: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 -> what the network takes: normalized, NCHW
        shape, in ``memory_format`` (a view, with no copy, in
        channels-last)."""
        x = device_normalize_images(images_u8, self.dtype).permute(0, 3, 1, 2)
        return x.contiguous(memory_format=self.memory_format)

    def forward(self, images_u8: torch.Tensor) -> dict:
        """The spans ``serve/normalize``, ``serve/model`` and
        ``serve/postprocess`` (``utils/profiler.py``), in turn;
        ``serve/model`` counts ``replayed`` 0 unless the model call replays
        a CUDA graph (``infer/graphs.py``)."""
        with span("serve/normalize"):
            x = self.network_input(images_u8)
        with span("serve/model", replayed=0):
            raw = self.model(x, split_head=True)
        with span("serve/postprocess"):
            # NHWC views of the maps: the select kernel reads them in place
            maps = [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in raw]
            return fused_postprocess(
                maps,
                self.num_classes,
                self.reg_max,
                conf_thresh=self.conf_thresh,
                iou_thresh=self.iou_thresh,
                max_det=self.max_det,
                pre_nms_topk=self.pre_nms_topk,
            )


def load_program(path: str, device=None) -> nn.Module:
    """A program written by ``export_program`` -> a module that maps
    [batch, H, W, 3] uint8 on ``device`` to the detection dict, with its
    parameters frozen. ``device`` resolves as everywhere in the port (the
    card unless ``"cpu"``); it must be the device the program was exported
    on, which its weights and graph are tied to."""
    # register yolo_ms_tpu_torch::select_scales and ::nms_fixed, which the
    # program calls
    import yolo_ms_tpu_torch.ops.kernels.nms  # noqa: F401
    import yolo_ms_tpu_torch.ops.kernels.select  # noqa: F401

    dev = resolve_device(device)
    program = torch.export.load(path)
    where = {t.device.type for t in program.state_dict.values()}
    if where != {dev.type}:
        raise ValueError(
            f"{path} was exported for {sorted(where)}, not {dev.type}: "
            f"export it again with --device {dev.type}"
        )
    return program.module().requires_grad_(False)
