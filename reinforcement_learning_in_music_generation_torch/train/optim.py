"""Adam with global-norm clipping and the learning-rate schedules: the
counterpart of the JAX package's ``train/optim.py``.

It follows optax's semantics (``optax.chain(clip_by_global_norm(c),
inject_hyperparams(adam)(lr, b1, b2, eps))``), not ``torch.optim``'s:

  * clipping scales every gradient by max_norm / g_norm only when
    g_norm >= max_norm, as ``(g / g_norm) * max_norm``, with no epsilon
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
  * Adam corrects both moments for bias, 1 - b^t computed in float32 as
    optax does, and adds eps outside the square root;
  * a schedule is evaluated at the optimizer step count before the update.

Parameters, gradients and moments are nested dicts of tensors (the JAX
parameter tree).  ``value_and_grad`` is ``jax.value_and_grad(has_aux=True)``
on such a tree; ``apply_updates`` adds the updates in place.  ``zero1``
wraps ``Adam`` so that each rank of a dp mesh keeps a slice of the moments.
Under a tp mesh each rank holds its shards of the parameters, gradients and
moments; Adam is elementwise, so only the clip's global norm needs the
mesh (``Adam.clip``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts with the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves: Sequence):
    """The leaves (in ``tree_leaves`` order) put back into template's shape."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def _aux_tensors(aux) -> list:
    """The tensors of ``aux`` (a tensor, or tuples, lists and dicts of
    them and of other values), in order."""
    if torch.is_tensor(aux):
        return [aux]
    if isinstance(aux, dict):
        aux = list(aux.values())
    if isinstance(aux, (tuple, list)):
        return [t for a in aux for t in _aux_tensors(a)]
    return []


def value_and_grad(loss_fn: Callable, params: dict, dp_mesh=None):
    """(loss, aux, grads) of ``loss_fn(params) -> (loss, aux)``: grads is a
    tree like ``params``, each leaf in its parameter's dtype; leaves the
    loss does not reach get zeros.  The loss is taken on detached copies of
    the leaves, so ``params`` may be updated in place afterwards.

    Under a ``dp_mesh`` with dp > 1, ``loss_fn`` gives this rank's share of
    the global loss (``ops/losses.py``): the gradients, the loss and the
    tensors of ``aux`` are summed over the dp group (one all-reduce a
    dtype), detached, so every rank holds the global ones (under tp, those
    of its shards)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g.to(t.dtype) for g, t in zip(grads, leaves)]
    if dp_mesh is not None and dp_mesh.dp > 1:
        from ..parallel.mesh import all_reduce_
        loss = loss.detach()
        all_reduce_(dp_mesh, grads + [loss] + _aux_tensors(aux), axis="dp")
    return loss, aux, tree_unflatten(params, grads)


def multistep_lr(init_lr: float, milestones: Sequence[int], gamma: float = 0.1) -> Schedule:
    """torch MultiStepLR: init_lr * gamma per milestone reached
    (optax.piecewise_constant_schedule: a step equal to a milestone is
    already decayed)."""
    bounds = sorted({int(m) for m in milestones})

    def schedule(count: int) -> float:
        v = init_lr
        for m in bounds:
            if count >= m:
                v *= gamma
        return v
    return schedule


def step_lr(init_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """torch StepLR: decay every ``step_size`` steps."""
    def schedule(count: int) -> float:
        return init_lr * (gamma ** (count // step_size))
    return schedule


def global_norm(grads: dict, mesh=None) -> torch.Tensor:
    """The l2 norm of the whole gradient.  Under a tp mesh the leaves the
    Megatron rules split are the rank's shards: their squared norms are
    summed over the tp group (one all-reduce), the whole leaves' counted
    once; every rank gets the norm optax computes on the global arrays."""
    sq = lambda g: torch.sum(g.float() * g.float())
    leaves = tree_leaves(grads)
    if mesh is None or mesh.tp == 1:
        return torch.sqrt(sum(sq(g) for g in leaves))
    from ..parallel.mesh import all_reduce_
    from ..parallel.sharding import tp_axes
    axes = tp_axes(grads)
    part = torch.stack([sq(g) for g, a in zip(leaves, axes) if a is not None]).sum()
    all_reduce_(mesh, [part], axis="tp")
    return torch.sqrt(part + sum(sq(g) for g, a in zip(leaves, axes) if a is None))


class AdamState(NamedTuple):
    mu: dict            # first moments, the params' tree
    nu: dict            # second moments
    count: int          # optimizer steps taken


class Adam:
    """Global-norm clipping (optional) followed by Adam."""

    def __init__(self, lr: Union[float, Schedule], grad_clip: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.grad_clip = lr, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> AdamState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamState(tree_map(zeros, params), tree_map(zeros, params), 0)

    def learning_rate(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def clip(self, grads: dict, mesh=None) -> dict:
        """The gradients scaled to ``grad_clip`` where their global norm
        reaches it (optax ``clip_by_global_norm``).  Under a tp ``mesh``
        ``grads`` are the rank's shards: the norm is that of the whole
        gradient (``global_norm``), the same on every rank."""
        if self.grad_clip is None:
            return grads
        g_norm = global_norm(grads, mesh)
        keep = g_norm < self.grad_clip
        return tree_map(lambda g: torch.where(keep, g, (g / g_norm) * self.grad_clip), grads)

    def update(self, grads: dict, state: AdamState, params: Optional[dict] = None,
               mesh=None):
        """-> (updates, state'); no host synchronisation.  ``mesh``: the
        step's mesh, which the clip's norm reads."""
        return self.adam_update(self.clip(grads, mesh), state)

    def adam_update(self, grads: dict, state: AdamState):
        """Adam on clipped gradients -> (updates, state'); elementwise, so a
        slice of the gradients and moments gives that slice of the result."""
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        # 1 - b^t in float32, as optax's bias_correction
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        lr = self.learning_rate(state.count)
        mu = tree_map(lambda g, m: (1.0 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1.0 - b2) * (g * g) + b2 * v, grads, state.nu)
        updates = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + self.eps) * (-lr),
                           mu, nu)
        return updates, AdamState(mu, nu, count)


def adam(lr: Union[float, Schedule], *, grad_clip: Optional[float] = None, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> Adam:
    return Adam(lr, grad_clip=grad_clip, b1=b1, b2=b2, eps=eps)


class Zero1:
    """ZeRO-1 around an ``Adam`` (JAX ``train/optim.py zero1``): each rank
    keeps Adam's moments only for its slice of every leaf along the
    dimension that ``parallel.zero1_specs`` gives it "dp" (leaves without
    one keep whole moments); the ranks of dp index i hold slice i.  The
    gradients arrive all-reduced over the dp group, so every rank clips the
    same global gradient; it then updates its slice and the updates are
    all-gathered over the dp group (one collective a step).  Under tp the
    trees are the rank's tp shards, whose "dp" dimension is whole.  Adam is elementwise,
    so the result is bit-equal to the unsliced ``Adam``: only the moments'
    memory changes (1/dp of the sliced leaves')."""

    def __init__(self, tx: Adam, mesh, params: dict):
        from ..parallel.sharding import dp_axis, zero1_specs
        self.tx, self.mesh = tx, mesh
        self.axes = tree_map(dp_axis, zero1_specs(mesh, params))

    def _slice(self, t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        if axis is None:
            return t
        k = t.shape[axis] // self.mesh.dp
        return t.narrow(axis, self.mesh.dp_index * k, k)

    def local(self, tree: dict) -> dict:
        """This rank's slice of each leaf of a tree like the params."""
        return tree_map(lambda t, a: self._slice(t, a).contiguous(), tree, self.axes)

    def gather(self, tree: dict) -> dict:
        """Every rank's slices of a tree like the params, put back whole:
        one all-gather of all the sliced leaves flattened together."""
        from ..parallel.mesh import all_gather
        leaves, axes = tree_leaves(tree), tree_leaves(self.axes)
        sliced = [i for i, a in enumerate(axes) if a is not None]
        if not sliced:
            return tree
        parts = all_gather(self.mesh, torch.cat([leaves[i].reshape(-1) for i in sliced]),
                           axis="dp")
        whole = list(leaves)
        off = 0
        for i in sliced:
            n = leaves[i].numel()
            whole[i] = torch.cat([p[off:off + n].view_as(leaves[i]) for p in parts], axes[i])
            off += n
        return tree_unflatten(tree, whole)

    def init(self, params: dict) -> AdamState:
        state = self.tx.init(params)
        return AdamState(self.local(state.mu), self.local(state.nu), 0)

    def update(self, grads: dict, state: AdamState, params: Optional[dict] = None,
               mesh=None):
        """-> (whole updates, state' with this rank's slices); the clip
        reads the mesh ZeRO-1 was made with."""
        updates, state = self.tx.adam_update(self.local(self.tx.clip(grads, self.mesh)), state)
        return self.gather(updates), state

    def full_state(self, state: AdamState) -> AdamState:
        """The whole moments (a collective: every rank calls it)."""
        return AdamState(self.gather(state.mu), self.gather(state.nu), state.count)

    def local_state(self, state: AdamState) -> AdamState:
        """This rank's slices of whole moments (a checkpoint's)."""
        return AdamState(self.local(state.mu), self.local(state.nu), state.count)


def zero1(tx: Adam, mesh, params: dict) -> Zero1:
    return Zero1(tx, mesh, params)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """params += updates, in place; returns params."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params
