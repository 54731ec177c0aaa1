"""Serving: share of the forward's BN-folded convs whose bias and activation
ran in the program's epilogue kernel, over the ``serve/model`` spans of the
stretch (%): 100 x the sum of ``conv_epilogues`` over the sum of
``conv_biased``. None where the program counts no such convs."""

from portbench.spans import stretch_spans


def read(trace):
    found = [s.counts for s in stretch_spans(trace)
             if s.name == "serve/model" and s.counts.get("conv_biased")]
    if not found:
        return None
    return (100.0 * sum(c.get("conv_epilogues", 0) for c in found)
            / sum(c["conv_biased"] for c in found))
