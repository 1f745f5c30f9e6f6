"""The port's entry file (port of ``__graft_entry__.py``).

* :func:`entry` returns ``(fn, example_args)``: the flagship model's eval
  forward (the Cora-preset ``GAT_sparse``) on a 2,708-node, 1,536-feature
  synthetic citation graph, on CUDA unless the caller asks for the CPU.
* :func:`dryrun_multichip` is not ported yet: its JAX counterpart runs one
  training step over an n-device mesh with a model axis at n >= 4
  (``__graft_entry__.py:99``), which is ROADMAP item 18; it raises.

    python -m pygat_tpu_torch.graft_entry [--no-cuda]
"""

from __future__ import annotations

import torch


def entry(device=None):
    """(fn, (params, x, graph)): ``fn(params, x, graph)`` is the eval
    forward (no dropout) of the Cora-preset GAT_sparse at 1,536 input
    features, and the example arguments its parameters (seeded with 72), the
    features and the graph of the JAX entry's planted-partition citation
    graph (``data.synthetic.clustered_citation(spread=None)``), on ``device``
    (CUDA unless the caller names another device; raises without CUDA)."""
    from pygat_tpu_torch.data.synthetic import clustered_citation
    from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.utils.platform import make_generator, resolve_device

    device = resolve_device(device)
    data = clustered_citation(2708, 1536, 7, "graft-entry", None,
                              device=device)
    cfg = GATConfig(layer_type="GAT_sparse", **PRESETS["cora"])
    cfg = cfg._replace(nfeats=(1536,) + cfg.nfeats[1:])
    params = init_gat(cfg, make_generator("cpu", 72), device=device)

    def fn(params, x, graph):
        return apply_gat(params, cfg, x, graph, None, train=False)

    return fn, (params, data.features, data.graph)


def dryrun_multichip(n_devices: int) -> None:
    """Not ported yet: one training step over an ``n_devices`` mesh with a
    model axis (heads over a model group) at ``n_devices >= 4``, the JAX
    package's GSPMD, ring and inductive data-parallel steps in one call.
    The port's mesh has no model axis yet (ROADMAP item 18); raises."""
    from pygat_tpu_torch.parallel.mesh import ITEM_18

    raise NotImplementedError(
        f"dryrun_multichip({n_devices}) is not ported yet ({ITEM_18}); "
        "the data axis alone runs through cli.train --mesh D,1 and "
        "tools/ring_check.py")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="the flagship forward, once")
    p.add_argument("--no-cuda", action="store_true", default=False)
    args = p.parse_args(argv)
    fn, example = entry("cpu" if args.no_cuda else None)
    with torch.no_grad():
        out = fn(*example)
    if out.is_cuda:
        torch.cuda.synchronize()
    print("entry OK:", tuple(out.shape), out.dtype,
          bool(torch.isfinite(out).all()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
