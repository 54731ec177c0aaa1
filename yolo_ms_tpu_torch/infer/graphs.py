"""The serving forward replayed as a CUDA graph, captured once per input key.

``GraphedForward(model)`` is the module that ``Predictor`` puts between its
``ServingProgram`` (``infer/program.py``) and its model: ``Predictor.serve.
model``. A call ``forward(x, split_head)`` runs ``model(x, split_head=)``
as one ``torch.cuda.CUDAGraph`` replay where the rule below allows it, and
eagerly otherwise. Only the forward is captured: normalize, the
post-process (the ``select`` and NMS launches that ``select.launches`` and
``nms.launches`` count), the upload and the download run as they do without
it.

The rule, read from the call, with no switch:

- ``x`` lies on a device type in ``CAPTURED_ON`` (the card; tests may widen
  or narrow it, as ``infer/layouts.py:ENABLED_ON``);
- no module of the model has a spatial group (``nn/blocks.py:
  set_spatial_group``): a height-sharded forward runs collectives;
- the call runs under ``torch.inference_mode()``, as ``Predictor.infer``
  does: a forward that autograd may record, or that ``torch.export``
  traces, stays eager.

The key of a graph is the input's shape, strides (its memory format),
dtype and device, and ``split_head``. The first call with a key copies
``x`` into the graph's static input, runs the forward eagerly on a side
stream (``WARMUP_CALLS``, as ``torch.cuda.make_graphed_callables``
does), captures it and replays it; every later call copies ``x`` into the
static input (one device copy) and replays. The head's maps come back as
the graph's static outputs: a later replay overwrites them, so the caller
reads them in stream order before its next call (``fused_postprocess``
makes new tensors). The graphs of one module share one memory pool; they
are replayed one at a time on the current stream of ``x``'s card. Capture
and replay run on ``x``'s card whichever card is current, as the kernel
wrappers launch (``ops/kernels/select.py``): a capture on another card's
stream would record nothing of the forward.

A capture that fails, or whose graph holds no nodes, raises with its key:
nothing falls back in silence.
A conversion of the weights through the module (``.to(memory_format=)``,
as ``AutoLayoutInfer`` does when a test forces it on after a call) drops
the captured graphs, whose kernels read the old weights' memory.

``tally`` counts the captures and the replays of this process; a call that
captures counts as a capture alone. Inside the span ``serve/model``
(``utils/profiler.py``) a replay sets the count ``replayed`` to 1, and
every call sets what the forward's modules count
(``utils/profiler.py:counted``: its BN-folded convs and their epilogues,
its attention calls), as the capture counted them for a replay: none for a
model that counts nothing. A capture runs on the card under inference
mode, so a replay's ``conv_epilogues`` equal its ``conv_biased``: every
deploy conv's bias and SiLU run in the epilogue kernel inside the graph
(its first launch, and its build, in the eager warm-up).
"""

from __future__ import annotations

import torch
from torch import nn

from yolo_ms_tpu_torch.utils.profiler import annotate, counted

# The device types on which the forward is captured.
CAPTURED_ON = ("cuda",)
# eager forwards on a side stream before a capture
WARMUP_CALLS = 3

# captures and replays of the serving graphs in this process
tally = {"captures": 0, "replays": 0}


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The number of nodes of a captured ``CUDAGraph(keep_graph=True)``, by
    ``cuGraphGetNodes`` of ``libcuda``."""
    import ctypes

    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes returned CUresult {err}")
    return count.value


class GraphedForward(nn.Module):
    """``model``'s forward, replayed from a CUDA graph per input key where
    the module docstring's rule allows it. ``self.model`` is ``model``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        self._sites = [m for m in model.modules() if hasattr(m, "spatial_rows")]
        self._graphs = {}  # key -> (graph, static input, static output)
        self._counts = {}  # key -> the counts of the captured forward
        self._pool = None

    def _captures(self, x: torch.Tensor) -> bool:
        return (x.device.type in CAPTURED_ON
                and all(m.spatial_rows is None for m in self._sites)
                and torch.is_inference_mode_enabled())

    def forward(self, x: torch.Tensor, split_head: bool = False):
        if not self._captures(x):
            with counted() as counts:
                out = self.model(x, split_head=split_head)
            annotate("serve/model", **counts)
            return out
        key = (tuple(x.shape), x.stride(), x.dtype, x.device, split_head)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key, x)
            tally["captures"] += 1
        else:
            entry[1].copy_(x)
            tally["replays"] += 1
            annotate("serve/model", replayed=1)
        annotate("serve/model", **self._counts[key])
        with torch.cuda.device(x.device):  # the graph's card, whichever is current
            entry[0].replay()
        return entry[2]

    def _capture(self, key: tuple, x: torch.Tensor) -> tuple:
        """The graph of ``key``, its static input holding ``x``."""
        shape, stride, dtype, device, split_head = key
        try:
            # on ``x``'s card throughout, whichever card is current: the
            # capture stream, the warm-up's side stream and the replays
            with torch.cuda.device(device):
                static_in = torch.empty_strided(shape, stride, dtype=dtype, device=device)
                static_in.copy_(x)
                current = torch.cuda.current_stream(device)
                side = torch.cuda.Stream(device)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    for _ in range(WARMUP_CALLS):
                        self.model(static_in, split_head=split_head)
                current.wait_stream(side)
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                # thread_local: a thread that stages the next batch meanwhile
                # (``Predictor.predict_paths``) does not void the capture
                with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                      capture_error_mode="thread_local"), counted() as counts:
                    static_out = self.model(static_in, split_head=split_head)
                if graph_nodes(graph) == 0:
                    raise RuntimeError("the captured graph holds no nodes")
                graph.instantiate()
        except Exception as e:
            raise RuntimeError(
                f"serving graph: the capture of the forward failed for input {list(shape)} "
                f"strides {list(stride)} {dtype} on {device} (split_head={split_head})"
            ) from e
        self._counts[key] = counts
        return graph, static_in, static_out

    def _apply(self, fn, recurse=True):
        self._graphs.clear()  # their kernels read the weights' old memory
        self._counts.clear()
        return super()._apply(fn, recurse)
