"""100 × the (token, expert) pairs the traced batch's decode steps kept
over the expert slots their products ran over (the program's counters
``moe.pairs_kept`` and ``moe.slots``; ``bench/spans.py``): the share of
the dense MoE decode's work that was a routed token's."""

from bench.spans import slot_fill


def read(run):
    return slot_fill(run, "decode")
