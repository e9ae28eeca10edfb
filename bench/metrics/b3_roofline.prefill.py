"""B3's share of its roofline in the traced prefill: the least time of its
causal attention at the cell's shapes (``work.b3_prefill``: bf16 products
at 989 TFLOP/s, q, k, v and o at 3.35 TB/s), one call an attention layer,
over the summed time of the kernels named ``flash_fwd`` there."""

from bench.metrics.common import roofline
from bench.peaks import least_seconds


def read(run):
    flops, nbytes = run.work.b3_prefill(run.mix["batch"],
                                        run.mix["max_prompt"])
    return roofline(run, "flash_fwd", least_seconds(flops=flops,
                                                    nbytes=nbytes),
                    run.work.n_attention())
