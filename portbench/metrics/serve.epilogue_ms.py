"""Serving: device ms per call of the program's conv epilogue kernel (the
names ``yolo_ms_tpu_torch/ops/kernels/epilogue.py:KERNEL`` matches). None
where the ``serve/model`` spans carry no ``conv_epilogues`` count (a program
without the kernel) or the trace holds no device operations (the CPU
rehearsal); raises where the profile holds another number of these kernels
than the spans counted epilogues."""

from portbench.spans import stretch_spans


def read(trace):
    found = [s.counts["conv_epilogues"] for s in stretch_spans(trace)
             if s.name == "serve/model" and s.counts.get("conv_epilogues")]
    if not found or not trace.ops:
        return None
    from yolo_ms_tpu_torch.ops.kernels.epilogue import KERNEL

    ops = [o for o in trace.ops if KERNEL.search(o.name)]
    if len(ops) != sum(found):
        raise RuntimeError(f"the profile holds {len(ops)} epilogue kernels, but the spans "
                           f"counted {sum(found)} epilogues: it lost events, or the kernel "
                           "was renamed")
    return trace.per_call_ms(ops)
