"""The bytes the first batch's decode steps need (``work.decode_bytes``,
with each step's distinct routed experts, ``Run.routed``) over their
device time (CUDA events) times 3.35 TB/s."""

from bench.peaks import HBM_BYTES_PER_S


def read(run):
    if run.routed is None or not run.batches:
        return None
    b, s = run.mix["batch"], run.mix["max_prompt"]
    need = took = 0.0
    for j, t in enumerate(run.batches[0].get("decode_dev", [])):
        need += run.work.decode_bytes(b, s + j, run.routed[j])
        took += t
    return 100.0 * need / (took * HBM_BYTES_PER_S) if took else None
