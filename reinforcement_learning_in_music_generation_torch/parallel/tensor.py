"""Megatron tensor parallelism's collectives, as autograd functions over a
mesh's tp group: the port's counterpart of the collectives that GSPMD
inserts around the JAX package's tp-sharded products, and of ``psum('tp')``
in its manual Megatron layer (``parallel/pipeline.py _layer_forward_tp``).

Between layers the activations are replicated: equal on every rank of a tp
group, and so are their gradients.  Two conjugate pairs move between that
and the rank's shard:

  * ``copy_to_tp`` (identity; backward all-reduce) before a column-parallel
    product, whose input gradient each rank holds only its columns' part of;
  * ``reduce_from_tp`` (all-reduce; backward identity) after a row-parallel
    product, whose output each rank holds a partial sum of;
  * ``gather_from_tp`` (all-gather of the last dimension; backward the
    rank's slice) after a column-parallel product whose output the next
    step reads whole (the embeddings, ``in_linear``);
  * ``scatter_to_tp`` (the rank's slice of the last dimension; backward
    all-gather) where a replicated tensor feeds a row-parallel product (the
    heads).

One more pair serves the sequence-parallel attention
(``ops/linear_attention.py causal_linear_attention_sp``) over any axis:

  * ``gather_over`` (every rank's tensor, stacked in the axis's order;
    backward each rank's slot of the cotangent summed over the ranks: the
    transpose of JAX's ``all_gather``, a reduce-scatter, done as an
    all-reduce and the rank's slot, which gloo carries).

And one the AIRL discriminator's batch split over dp takes
(``models/longformer.py``: its BatchNorm's statistics over the global
minibatch):

  * ``sum_over`` (all-reduce over any axis; backward all-reduce too: each
    rank's loss reads every rank's share through the sum, so the cotangent
    of a rank's share is the sum of the ranks' cotangents of the total).
    ``reduce_from_tp``'s backward, the identity, is right only where the
    loss and its cotangent are the same on every rank; here each rank holds
    its own share of the loss.

Each function's backward is its conjugate, itself an autograd function,
so a second derivative through them (the AIRL gradient penalty's,
``rl/airl.py``) takes the conjugate's collective again.

``reduce_from_tp`` is not ``torch.distributed.nn.functional.all_reduce``:
that one all-reduces the gradient again on the way back, and since the
loss and its gradient are the same on every tp rank, it would multiply the
gradients by tp.  A bf16 partial sum is all-reduced in f32 and rounded
once; over gloo bf16 tensors are gathered as f32.  With no mesh, or a tp
of 1, every function returns its input.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def _all_reduce(mesh, x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    y = x.float() if x.dtype == torch.bfloat16 else x.clone()
    dist.all_reduce(y, group=mesh.group(axis))
    return y.to(x.dtype)


def _all_gather_last(mesh, x: torch.Tensor) -> torch.Tensor:
    """The tp ranks' ``x`` side by side on the last dimension (bf16 widened
    to f32, losslessly, over gloo, which is not asked to carry bf16)."""
    wide = x.dtype == torch.bfloat16 and mesh.backend == "gloo"
    src = (x.float() if wide else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.tp)]
    dist.all_gather(parts, src, group=mesh.group("tp"))
    return torch.cat(parts, dim=-1).to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mesh), None


class _GatherFields(torch.autograd.Function):
    """The rank's column shards of several fields, concatenated, -> every
    field whole, concatenated in field order: one all-gather, then the
    parts reordered field by field (gathering the concat as one block would
    interleave the fields).  Backward: each field's slice of the rank."""

    @staticmethod
    def forward(ctx, x, mesh, sizes):
        ctx.mesh, ctx.sizes = mesh, sizes
        parts = _all_gather_last(mesh, x).split(sum(sizes), dim=-1)
        return torch.cat([p.narrow(-1, off, n) for off, n in _offsets(sizes)
                          for p in parts], dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _ScatterFields.apply(g, ctx.mesh, ctx.sizes), None, None


class _ScatterFields(torch.autograd.Function):
    """Fields of ``tp * sizes`` columns, whole and concatenated -> the rank's
    column shard of each, concatenated.  Backward: the fields gathered."""

    @staticmethod
    def forward(ctx, x, mesh, sizes):
        ctx.mesh, ctx.sizes = mesh, sizes
        tp, i = mesh.tp, mesh.tp_index
        return torch.cat([x.narrow(-1, tp * off + i * n, n) for off, n in _offsets(sizes)],
                         dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _GatherFields.apply(g, ctx.mesh, ctx.sizes), None, None


class _GatherOver(torch.autograd.Function):
    """Every rank's ``x`` of an axis, stacked -> (n, *x.shape); backward
    the rank's slot of the cotangent summed over the ranks."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        wide = x.dtype == torch.bfloat16 and mesh.backend == "gloo"
        src = (x.float() if wide else x).contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
        dist.all_gather(parts, src, group=mesh.group(axis))
        return torch.stack(parts).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterOver.apply(g, ctx.mesh, ctx.axis), None, None


class _ReduceScatterOver(torch.autograd.Function):
    """(n, ...) on every rank of an axis -> the sum over the ranks of their
    slot of this rank's index; backward the cotangents gathered."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(mesh, x, axis)[mesh.index(axis)]

    @staticmethod
    def backward(ctx, g):
        return _GatherOver.apply(g, ctx.mesh, ctx.axis), None, None


class _SumOver(torch.autograd.Function):
    """The sum over the ranks of an axis, forward and backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _SumOver.apply(g, ctx.mesh, ctx.axis), None, None


def sum_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of the ranks of ``axis``'s ``x``, on every rank;
    differentiable, each rank's cotangent summed over the ranks in the
    backward."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _SumOver.apply(x, mesh, axis)


def gather_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ranks of ``axis``'s ``x`` (the same shape on each), stacked in
    the order of their index -> (n, *x.shape); differentiable (the
    transpose of JAX's ``all_gather``)."""
    if mesh.size(axis) == 1:
        return x[None]
    return _GatherOver.apply(x, mesh, axis)


def _offsets(sizes: Sequence[int]):
    off = 0
    for n in sizes:
        yield off, n
        off += n


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (replicated) as the input of a column-parallel product."""
    return x if _tp(mesh) == 1 else _Copy.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the tp ranks of their partial sums ``x``."""
    return x if _tp(mesh) == 1 else _Reduce.apply(x, mesh)


def gather_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The tp ranks' column shards ``x`` (..., n/tp) -> (..., n), in rank
    order (one field of ``gather_fields_from_tp``)."""
    return gather_fields_from_tp(x, mesh, [x.shape[-1]])


def scatter_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's column shard of a replicated ``x`` (..., n) -> (..., n/tp)."""
    return x if _tp(mesh) == 1 else _ScatterFields.apply(x, mesh, (x.shape[-1] // mesh.tp,))


def gather_fields_from_tp(x: torch.Tensor, mesh, sizes: Sequence[int]) -> torch.Tensor:
    """``x`` (..., sum(sizes)): the rank's column shards of fields of
    ``sizes`` columns a rank, side by side -> (..., tp sum(sizes)), each
    field whole, in field order."""
    return x if _tp(mesh) == 1 else _GatherFields.apply(x, mesh, tuple(sizes))
