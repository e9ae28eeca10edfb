"""Capturing a step of work as one CUDA graph: what the serving steps
(``launch/serve.py``) and the fused loop body (``backends/loop_body.py``)
share."""

from __future__ import annotations

import torch


def capture(device: torch.device, warm_up, body):
    """Run ``warm_up()`` once on a side stream (it builds and loads what
    ``body`` launches; its result is dropped), then capture ``body()`` into
    a ``torch.cuda.CUDAGraph``, whose memory comes from the graph's own
    pool.  Returns ``(graph, what body returned)``: static buffers that
    every replay overwrites.  Anything in ``body`` that the card cannot
    capture (a host read of a device value, a copy from pageable host
    memory) raises here: there is no eager fallback."""
    stream = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        warm_up()
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    return graph, out
