"""A throwaway benchmark layout at the port's SMOKE sizes, in a temporary
directory, for the CPU tests: its own BENCHMARK.json, configuration files
(the cells' files with the SMOKE widths), traffic mix, limits and a metric
of its own; the references and work counts are the real files, copied
under the throwaway names, so the harness finds everything by name."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parents[1]

#: the SMOKE sizes of the two configurations (``configs/*.py``), as
#: published keys and port fields
TINY = {
    "tiny-olmoe": ("olmoe-1b-7b", {
        "hidden_size": 64, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 2, "num_experts": 4,
        "num_experts_per_tok": 2, "vocab_size": 128}, {
        "n_layers": 2, "d_model": 64, "n_heads": 2, "n_kv_heads": 2,
        "d_ff": 64, "vocab_size": 128,
        "moe": {"n_experts": 4, "top_k": 2, "d_expert": 64}}),
    "tiny-jamba": ("jamba-v0.1-52b", {
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 8,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_experts": 4,
        "num_experts_per_tok": 2, "mamba_d_state": 8, "mamba_dt_rank": 4,
        "vocab_size": 128}, {
        "n_layers": 8, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 128, "vocab_size": 128,
        "moe": {"n_experts": 4, "top_k": 2, "d_expert": 128},
        "mamba": {"d_state": 8, "d_conv": 4, "expand": 2, "dt_rank": 4}}),
}

TRAFFIC = {"why": "tiny", "batch": 2, "max_prompt": 48, "new_tokens": 5,
           "prompt": {"dist": "uniform", "min": 8, "max": 48},
           "check_requests": 2}

#: the tiny bf16 cells' ``logit_rms_worst_block`` limits (blocks of 2
#: positions), between the program's and the FP8 control's readings on
#: the CPU on seeds 2 and 3: OLMoE 0.010, 0.008 against 0.155, 0.180;
#: Jamba 0.077, 0.057 against 0.366, 0.633.  Over seeds 2-21 the two
#: overlap at these widths (OLMoE's program up to 0.179, its control down
#: to 0.083; Jamba's 0.652 against 0.282: near-ties of 4 experts at d 64
#: and Mamba layers at d 64), so the cells' own limits come from the card
LIMITS = {"tiny-olmoe": 0.05, "tiny-jamba": 0.2}


def make(tmp: Path, dtype: str = "bfloat16",
         rms_limit: Optional[float] = None) -> Path:
    """A throwaway checkout root under ``tmp`` with one cell a tiny
    configuration (``<config>.tiny``) and the metric ``tiny_requests``;
    each cell's limit is :data:`LIMITS`' unless ``rms_limit`` is given."""
    bench = tmp / "bench"
    for sub in ("configs", "traffic", "cells", "metrics", "reference",
                "work"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    (bench / "metrics" / "tiny_requests.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    for name in ("output_tokens_per_s", "setup_s"):
        shutil.copy(BENCH / "metrics" / f"{name}.py", bench / "metrics")
    configs, cells = [], []
    for name, (real, keys, port) in TINY.items():
        cfg = json.loads((BENCH / "configs" / f"{real}.json").read_text())
        cfg.update(keys)
        cfg["port"].update(port, name=name, dtype=dtype, param_dtype=dtype)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        for kind in ("reference", "work"):
            shutil.copy(BENCH / kind / f"{real}.py",
                        bench / kind / f"{name}.py")
        cell = f"{name}.tiny"
        (bench / "cells" / f"{cell}.json").write_text(
            json.dumps({"block": 2,
                        "limits": {"logit_rms_worst_block":
                                   LIMITS[name] if rms_limit is None
                                   else rms_limit,
                                   "excess_gap": 0.0}}))
        configs.append({"name": name, "source": "test", "reduced": [],
                        "file": f"bench/configs/{name}.json", "why": "test"})
        cells.append({"name": cell, "config": name, "traffic": "tiny",
                      "chips": 1, "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps({
        "command": ["python3", "bench/run.py"], "paths": ["bench"],
        "run_seconds": 1, "configs": configs, "workloads": cells,
        "end_to_end": [
            {"name": "output_tokens_per_s", "unit": "tokens/s",
             "better": "higher", "bound": 0.05, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "tiny_requests", "unit": "requests", "better": "higher",
             "source": "program_counter", "layer": "serve",
             "moves": "output_tokens_per_s"}]}))
    return tmp
