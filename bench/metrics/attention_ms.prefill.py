"""Device milliseconds of the traced batch's prefill in its attention
layers with their norms (the program's ``layer.attn*`` spans, summed;
``bench/spans.py``)."""

from bench.spans import layer_ms


def read(run):
    return layer_ms(run, "prefill", lambda n: n.startswith("layer.attn"))
