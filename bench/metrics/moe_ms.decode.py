"""Device milliseconds of a decode step's MoE layers with their norms (the
program's ``layer.moe`` spans), summed a step, median over the traced
batch's decode steps (``bench/spans.py``)."""

from bench.spans import layer_ms


def read(run):
    return layer_ms(run, "decode", lambda n: n == "layer.moe")
