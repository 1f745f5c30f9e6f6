"""Computation-graph introspection and numerics debugging (port of
``pygat_tpu/utils/debug.py``).

The reference's autograd visualizer (visualize_graph.py:6-62) walks
``grad_fn.next_functions`` and crashes on a stale import; its sparse layers
sprinkle NaN asserts (layers.py:138,147,157,162). Here:

* :func:`debug_nans` turns on autograd's anomaly detection and fails at the
  first operator that produces a NaN (the counterpart of
  ``jax_debug_nans``);
* :func:`checkify_step` wraps a train step and raises on a non-finite loss,
  gradient or parameter, naming which (the counterpart of checkify);
* :func:`op_histogram` counts the aten operators a call runs, and the
  port's kernel launches by name;
* :func:`dump_aten_graph` writes the aten graph of a forward (the
  counterpart of ``dump_jaxpr``), traced over the CPU's plain path;
  :func:`dump_hlo` has no counterpart in eager PyTorch and raises.

The hand-written kernels are launched through ``ctypes`` with raw device
pointers: no tracer sees inside them, and they are not aten operators, so
:func:`op_histogram` counts them from the wrappers' launch counters
(``ops.build.launch_counts``) and :func:`dump_aten_graph` traces the CPU
path, where each wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _tensors(o)


class _NanMode(TorchDispatchMode):
    """Raise at the first operator whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"{func} produced a NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the block, fail fast on NaN production: every aten operator's
    floating outputs are checked (a NaN raises ``FloatingPointError``
    naming the operator; an infinity passes, since the layers use -inf as
    a mask value, as ``jax_debug_nans`` lets it pass), and
    ``torch.autograd.set_detect_anomaly`` names the forward operator of a
    backward that produced one. Each check reads the device, so this is a
    debugging mode, not a training one. The kernels' outputs are checked
    where an operator reads them."""
    if not enable:
        yield
        return
    with torch.autograd.set_detect_anomaly(True), _NanMode():
        yield


def _named_parameters(params):
    """(name, tensor) of each parameter leaf: ``layer i W`` and so on."""
    for i, layer in enumerate(params):
        for field, t in zip(layer._fields, layer):
            if t is not None:
                yield f"layer {i} {field}", t


def check_finite(step_outputs, params=None) -> None:
    """Raise ``FloatingPointError`` naming the first non-finite value: a
    tensor among ``step_outputs`` (by its position), a parameter's
    gradient, or a parameter."""
    for i, t in enumerate(_tensors(step_outputs)):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"the step's output {i} (shape "
                                     f"{tuple(t.shape)}) is not finite")
    for name, p in _named_parameters(params or ()):
        if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
            raise FloatingPointError(f"the gradient of {name} is not finite")
        if not bool(torch.isfinite(p).all()):
            raise FloatingPointError(f"parameter {name} is not finite")


def checkify_step(step_fn: Callable) -> Callable:
    """Wrap a step (``train_step(state, ...) -> (state, loss, ...)``, or
    any function of tensors) so that a non-finite value surfaces where it
    appears instead of as silent garbage: after each call, every tensor it
    returned (the loss first among them), and where an argument or a
    result is a :class:`~pygat_tpu_torch.train.state.TrainState` its
    parameters' gradients and its parameters, are checked, and the first
    non-finite one raises ``FloatingPointError`` naming it."""
    from pygat_tpu_torch.train.state import TrainState

    def wrapped(*args, **kw):
        out = step_fn(*args, **kw)
        seq = out if isinstance(out, tuple) else (out,)
        states = [a for a in (*args, *seq) if isinstance(a, TrainState)]
        check_finite([o for o in seq if not isinstance(o, TrainState)],
                     states[0].params if states else None)
        return out

    return wrapped


class _CountMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def op_histogram(fn: Callable, *example_args, **kw) -> dict[str, int]:
    """Run ``fn(*example_args, **kw)`` once and count what it ran: each
    aten operator (``aten.mm`` ...) by dispatch, and each of the port's
    kernels as ``kernel:<name>`` from the launch counters (a ctypes launch
    is not an aten operator)."""
    from pygat_tpu_torch.ops import build

    before = build.launch_counts()
    with _CountMode() as mode:
        fn(*example_args, **kw)
    counts = dict(mode.counts)
    for name, n in build.launch_counts().items():
        if n - before.get(name, 0):
            counts[f"kernel:{name}"] = n - before.get(name, 0)
    return counts


def dump_aten_graph(fn: Callable, *example_args, path: str | None = None
                    ) -> str:
    """The aten graph of ``fn`` traced by
    ``torch.fx.experimental.proxy_tensor.make_fx`` on ``example_args``
    (returns its code, and writes it to ``path`` when given). Give it CPU
    tensors: on CUDA the kernels take raw pointers, which no tracer can
    follow, while on the CPU each wrapper runs its plain PyTorch version."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn)(*example_args)
    text = gm.code
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def dump_hlo(fn: Callable, *example_args, path: str | None = None,
             optimized: bool = False) -> str:
    """No counterpart in eager PyTorch: the port runs ATen operators and
    hand-written kernels, never an XLA program, and ``torch.compile``'s IR
    would describe another program than the one that trains. Raises; use
    :func:`dump_aten_graph`."""
    raise NotImplementedError(
        "dump_hlo has no counterpart in the eager PyTorch port: use "
        "dump_aten_graph (the aten graph of the CPU plain path) and "
        "op_histogram (aten operators and kernel launches)")


def main(argv=None) -> int:
    """Computation-graph dumper, the working counterpart of the reference's
    visualize_graph.py: the flagship forward's aten graph (traced over the
    CPU plain path) and its histogram of aten operators and kernel
    launches (on CUDA unless ``--no-cuda``), for any dataset and model."""
    import argparse
    import os

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--dataset", default="cora",
                   choices=["cora", "citeseer", "pubmed"])
    p.add_argument("--model", default="GAT_sparse",
                   choices=["GAT_sparse", "GATv2_sparse", "GAT", "GATv2"])
    p.add_argument("--out", default="output/graph",
                   help="prefix: writes <out>.aten.txt")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="the histogram on the CPU (the default device is "
                        "CUDA; without a GPU and without this flag it "
                        "raises)")
    args = p.parse_args(argv)

    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.utils.platform import make_generator, resolve_device

    device = resolve_device(cpu=args.no_cuda)
    data = load_citation(args.dataset, device=device)
    cfg = GATConfig(layer_type=args.model, **PRESETS[args.dataset])
    cfg = cfg._replace(nfeats=(int(data.features.shape[1]),) + cfg.nfeats[1:])

    def forward(dev):
        params = init_gat(cfg, make_generator("cpu", 72), device=dev)
        graph = data.graph.to(dev)

        @torch.no_grad()
        def fwd(x):
            return apply_gat(params, cfg, x, graph, None, train=False)

        return fwd

    hist = op_histogram(forward(device), data.features)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    dump_aten_graph(forward(torch.device("cpu")), data.features.cpu(),
                    path=args.out + ".aten.txt")
    top = sorted(hist.items(), key=lambda kv: -kv[1])[:15]
    print(f"wrote {args.out}.aten.txt")
    print(f"operator and kernel histogram on {device} (top 15):")
    for name, cnt in top:
        print(f"  {cnt:5d}  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
