"""The weights of a run, drawn by the benchmark from ``--seed`` on the
device: in the port's parameter tree (``transformer.abstract_params``
gives the shapes), every leaf the model casts for compute already in the
serving dtype, so the port's ``serving_params`` has nothing to cast.  One
``torch.randn`` a dtype fills a flat buffer, and each leaf is a view of it
scaled in place, so the draw is a few large calls.

Scales: a matrix ``1/sqrt(fan_in)`` (its second-to-last dim), the
embedding and the router 0.02 and Mamba's conv taps 0.5 (the port's
initial scales); norm gains around 1 (``1 + 0.1 n``: the port's zeros
would zero every activation of a model that scales by plain ``g``), biases
around 0; Mamba's ``a_log``, ``d`` and ``dt_bias`` the port's constants.

:func:`layers` gives the reference the same tensors one dict a layer, so
it never reads the port's stacking."""

from __future__ import annotations

import math

import torch

SCALE = {"embed": 0.02, "router": 0.02, "conv_w": 0.5}


def _walk(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _fill(name: str, view: torch.Tensor, cfg) -> None:
    if name == "g":
        view.mul_(0.1).add_(1.0)
    elif name in ("bq", "bk", "bv", "conv_b", "q_norm", "k_norm"):
        view.mul_(0.1)
    elif name == "a_log":
        n = view.shape[-1]
        view.copy_(torch.log(torch.arange(1, n + 1, dtype=view.dtype,
                                          device=view.device)).expand_as(view))
    elif name == "d":
        view.fill_(1.0)
    elif name == "dt_bias":
        view.fill_(0.1)
    else:
        view.mul_(SCALE.get(name, 1.0 / math.sqrt(view.shape[-2])))


def draw(cfg, seed: int, device, lap=None) -> dict:
    """The parameter tree of ``cfg`` drawn from ``seed`` on ``device``.
    ``lap(name)``, where given, is called after the shapes (``shapes``),
    the buffers' allocation (``allocate``) and the draw (``draw``)."""
    from repro_torch.models.transformer import COMPUTE_LEAVES, abstract_params
    lap = lap or (lambda name: None)
    shapes, _ = abstract_params(cfg)
    leaves = list(_walk(shapes))
    dtype_of = {path: cfg.compute_dtype if path[-1] in COMPUTE_LEAVES
                else meta.dtype for path, meta in leaves}
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    dtypes = sorted({*dtype_of.values()}, key=str)
    groups = {dtype: [(p, m) for p, m in leaves if dtype_of[p] == dtype]
              for dtype in dtypes}
    lap("shapes")
    bufs = {dtype: torch.empty(sum(m.numel() for _, m in group), dtype=dtype,
                               device=device)
            for dtype, group in groups.items()}
    lap("allocate")
    params: dict = {}
    for dtype in dtypes:
        group = groups[dtype]
        buf = bufs[dtype].normal_(generator=gen)   # as torch.randn draws
        at = 0
        for path, meta in group:
            view = buf[at:at + meta.numel()].view(meta.shape)
            at += meta.numel()
            _fill(path[-1], view, cfg)
            _set(params, path, view)
    lap("draw")
    return params


def layers(params: dict, cfg) -> dict:
    """The same tensors for the reference: ``embed``, ``final_norm``,
    ``lm_head`` and ``layers``, layer ``l`` being unit position ``l %
    len(unit)`` of group ``l // len(unit)`` of the port's stacking."""
    unit, n_groups = cfg.scan_groups()

    def index(tree, g):
        return {k: index(v, g) if isinstance(v, dict) else v[g]
                for k, v in tree.items()}

    per_layer = [index(params["groups"][f"l{l % len(unit)}"], l // len(unit))
                 for l in range(len(unit) * n_groups)]
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"], "layers": per_layer}
