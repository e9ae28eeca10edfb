"""Device milliseconds of the traced batch's prefill in its MoE layers
with their norms (the program's ``layer.moe`` spans, summed;
``bench/spans.py``)."""

from bench.spans import layer_ms


def read(run):
    return layer_ms(run, "prefill", lambda n: n == "layer.moe")
