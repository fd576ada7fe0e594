"""Gradients through the kernel entry points: the counterpart of the JAX
package's ``custom_vjp``s around its Pallas kernels
(``msgwam_tpu/models/rhs.py:_rhs_fused_diff``,
``models/integrate.py:_rk3_step_fused``, ``ops/step_pallas.py:
simulate_resident`` and ``ops/step_pallas_stream.py:
simulate_streaming_ensemble``).

:func:`kernel_call` runs an entry point's kernel forward (its plain twin
for CPU tensors) and, when autograd records, differentiates the port's
plain PyTorch path on the same inputs in the backward, as the JAX package
differentiates its XLA path.  So the backward is plain PyTorch and has no
kernel of its own; the forward stays the kernel's, bit for bit.  Only the
inputs are saved: the plain path is run again inside the backward, on
detached copies, and its intermediates live only there.

The entry points with such a backward are K2 (:func:`.rhs_cuda.rhs_fused`),
K3 and K4 (:mod:`.rhs_cuda_windowed`), K5 (:func:`.step_cuda.
simulate_resident`) and K7 (:func:`.step_cuda_stream.
simulate_streaming_ensemble`).  K1 and K6 stay forward only, as in the JAX
package (:func:`msgwam_tpu_torch._build.forward_only`).
"""

from __future__ import annotations

import torch


def plain_config(cfg, **changes):
    """The configuration of the plain path that a backward differentiates:
    the composable RHS with the dense ``mxu`` deposit and interpolation, as
    the JAX package's backwards take it; ``flux_accum`` and every other
    field are kept."""
    return cfg.replace(rhs_backend="xla", projection_backend="mxu",
                       interp_backend="mxu", **changes)


def _map(fn, tree):
    """``fn`` over the leaves of a tree of tuples, ``NamedTuple``s, lists
    and dicts, the structure rebuilt."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        children = [_map(fn, v) for v in tree]
        return type(tree)(*children) if hasattr(tree, "_fields") else tuple(children)
    return fn(tree)


def _leaves(tree):
    out = []
    _map(out.append, tree)
    return out


def _needs_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return False
    return any(_needs_grad(x) for x in tree)


class _Slot:
    """Where a tensor stood in a call's arguments."""


_SLOT = _Slot()


def _fill(skeleton, tensors):
    it = iter(tensors)
    return _map(lambda x: next(it) if x is _SLOT else x, skeleton)


class _Call:
    """What one recorded call keeps for its backward besides the saved
    inputs: the two functions, the arguments with their tensors taken out,
    and for each leaf of the kernel's result whether it is one of the
    Function's outputs (``("out", j)``), an input passed through
    (``("in", i)``) or a constant (``("leaf", value)``)."""

    def __init__(self, kernel, plain, skeleton):
        self.kernel = kernel
        self.plain = plain
        self.skeleton = skeleton
        self.result = None
        self.slots = None


class _KernelCall(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, *tensors):
        out = call.kernel(*_fill(call.skeleton, tensors))
        index = {id(t): i for i, t in enumerate(tensors)}
        outs, slots, seen = [], [], {}
        for leaf in _leaves(out):
            if not isinstance(leaf, torch.Tensor):
                slots.append(("leaf", leaf))
            elif id(leaf) in index:
                # an input passed through: its own gradient path carries it
                slots.append(("in", index[id(leaf)]))
            else:
                if id(leaf) not in seen:
                    seen[id(leaf)] = len(outs)
                    outs.append(leaf)
                slots.append(("out", seen[id(leaf)]))
        call.result, call.slots = _map(lambda _: _SLOT, out), slots
        ctx.call = call
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*(o for o in outs if not o.is_floating_point()))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            plain = _leaves(call.plain(*_fill(call.skeleton, inputs)))
        if len(plain) != len(call.slots):
            raise RuntimeError(
                f"the plain path returned {len(plain)} leaves where the "
                f"kernel returned {len(call.slots)}")
        ys, cts, done = [], [], set()
        for (kind, j), y in zip(call.slots, plain):
            if (kind == "out" and j not in done and grads[j] is not None
                    and isinstance(y, torch.Tensor) and y.requires_grad):
                done.add(j)
                ys.append(y)
                cts.append(grads[j].to(y.dtype))
        wrt = [x for x in inputs if x.requires_grad]
        got = (torch.autograd.grad(ys, wrt, cts, allow_unused=True) if ys
               else (None,) * len(wrt))
        got = iter(got)
        return (None, *(next(got) if x.requires_grad else None for x in inputs))


def kernel_call(kernel, plain, *args):
    """``kernel(*args)``, with the gradient of ``plain(*args)``.

    ``args`` are trees of tensors and constants; ``kernel`` and ``plain``
    return trees with the same leaves, tensor for tensor (a plain leaf that
    is a constant, such as a structural zero, passes no gradient).  When
    grad mode is off or no input needs a gradient, this is the plain call
    ``kernel(*args)``, and autograd records nothing.  Otherwise the result
    is the kernel's; its float tensors carry a backward that runs ``plain``
    on detached copies of the inputs and returns its vector-Jacobian
    product.  An input the kernel returns as it is keeps its own gradient
    path; bool and integer outputs carry none."""
    if not (torch.is_grad_enabled() and _needs_grad(args)):
        return kernel(*args)
    tensors = []
    skeleton = _map(lambda x: (tensors.append(x), _SLOT)[1]
                    if isinstance(x, torch.Tensor) else x, args)
    call = _Call(kernel, plain, skeleton)
    outs = _KernelCall.apply(call, *tensors)
    values = iter(tensors[j] if kind == "in" else outs[j] if kind == "out" else j
                  for kind, j in call.slots)
    result = _map(lambda _: next(values), call.result)
    call.result = None
    return result
