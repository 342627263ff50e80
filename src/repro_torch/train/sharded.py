"""Sharded training over ``torch.distributed`` (the counterpart of
``serve/sharded.py``): the reference's train step under pjit, the program
its dry-run lowers (``repro/launch/dryrun.py``): ``state.make_train_step``
with the parameters at ``param_pspecs``, the moments ZeRO-1 over the data
axes (``opt_state_pspecs``) and the logits split over the vocabulary
through the loss.

A ``TrainSharding`` plan holds the mesh (default: ``launch.mesh.
make_host_mesh()`` over the initialized process group), the production
rules table and two layouts: ``param_layout``, the reference's param specs,
which the parameters and their gradients take, and ``opt_layout``, which
adds the data axes to each leaf's first free dimension they divide (the
moments' layout, and the gradients' and the update's under ZeRO-1). A rank
holds the block of each leaf its layout gives it (``shard_params``, the
counterpart of ``jax.device_put(params, param_sharding)``), and its 'data'
block of the global batch's rows (``local_batch``).

``make_train_step(loss_fn, optimizer, plan)`` returns the step, the same
on every rank and on the dry-run's tensors without storage:

  1. the loss of the rank's rows under the plan's rules, with the model's
     collectives over 'model' (``dist/sharding.py``); the global mean of
     the batch: the rank's sum of position losses and its count of scored
     positions (the mask's sum) are all-reduced over the data axes;
  2. the backward of the rank's share of that mean, whose collectives over
     'model' are the forward's conjugates (the gradient of every
     replicated leaf whole on each 'model' rank);
  3. each gradient over the data axes: reduce-scattered to its
     ``opt_layout`` block, or all-reduced where ZeRO-1 cannot split the
     leaf;
  4. the clip's global norm over the blocks held (``global_norm``'s
     ``reduce``: each block counted once, however many ranks hold it) and
     AdamW on this rank's blocks of gradients, moments and params;
  5. the updated blocks all-gathered over the data axes into the rank's
     block of each param.

Real ranks train the dense family; the others' collectives under grad are
a later slice (ROADMAP A19), so the step refuses them on a process group,
while the dry-run runs every family's step on tensors without storage.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.dist import sharding as shd
from repro_torch.launch.dryrun import opt_state_pspecs
from repro_torch.launch.mesh import axis_sizes, make_host_mesh
from repro_torch.models.api import params_specs
from repro_torch.train.optimizer import Optimizer, leaves, tree_map


@dataclass
class TrainSharding:
    """Mesh, rules table and layouts of one config's sharded train step."""
    mesh: object
    table: dict
    cfg: object = field(repr=False)
    param_layout: object = field(repr=False)
    opt_layout: object = field(repr=False)

    def rules(self):
        """Context manager installing the logical-axis rules."""
        return shd.axis_rules(self.mesh, self.table)

    @property
    def data_axes(self) -> shd.MeshAxes:
        """The batch axes: "data", or ("pod", "data") on a multi-pod mesh
        (shape-only: the dry-run's)."""
        return ("pod", "data") if "pod" in self.mesh.axis_names else "data"

    @property
    def data_ranks(self) -> int:
        return shd.spec_ranks((self.data_axes,), axis_sizes(self.mesh))

    @property
    def data_index(self) -> int:
        """This rank's index along the data axes."""
        return shd.mesh_index(self.mesh, self.data_axes)

    def shard_params(self, params):
        """This rank's blocks of a full param tree."""
        return shd.tree_map_with_path(
            lambda path, leaf: shd.local_block(
                leaf, shd.leaf_at(self.param_layout, path), self.mesh),
            params)

    def local_batch(self, batch: dict) -> dict:
        """This 'data' rank's rows of a global batch (every row where the
        data axes do not divide the batch, as the dry-run's programs)."""
        n = self.data_ranks

        def rows(t):
            if n == 1 or t.shape[0] % n:
                return t
            per = t.shape[0] // n
            return t.narrow(0, self.data_index * per, per)
        return {k: rows(v) for k, v in batch.items()}

    def zero_dim(self, path) -> Optional[int]:
        """The dimension ZeRO-1 splits over the data axes in leaf
        ``path``'s ``opt_layout`` (None: the leaf stays whole over them)."""
        for d, (a, b) in enumerate(zip(shd.leaf_at(self.param_layout, path),
                                       shd.leaf_at(self.opt_layout, path))):
            if a != b:
                return d
        return None

    def zero_block(self, path, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 block of a param-layout tensor of leaf
        ``path``, a view (``t`` itself for a leaf ZeRO-1 does not split)."""
        d = self.zero_dim(path)
        if d is None:
            return t
        per = t.shape[d] // self.data_ranks
        return t.narrow(d, self.data_index * per, per)

    def gather(self, tree, layout=None):
        """The full tree from this rank's blocks of ``tree`` under
        ``layout`` (default ``param_layout``; ``opt_layout`` for the
        gradients a step keeps): each split leaf gathered over its mesh
        axes, every rank taking part."""
        layout = self.param_layout if layout is None else layout

        def join(path, leaf):
            with self.rules():
                for d, entry in enumerate(shd.leaf_at(layout, path)):
                    for a in reversed(shd._flat(entry)):   # inner first
                        leaf = shd.gather_over(leaf, d, a)
            return leaf
        return shd.tree_map_with_path(join, tree)

    def copies(self, path, layout=None) -> int:
        """The ranks that hold the same block of leaf ``path`` under
        ``layout`` (default ``opt_layout``: a gradient's block after step
        3)."""
        layout = self.opt_layout if layout is None else layout
        return self.mesh.size // shd.spec_ranks(shd.leaf_at(layout, path),
                                                axis_sizes(self.mesh))


def make_train_sharding(cfg, mesh=None, *, table: Optional[dict] = None,
                        zero1: bool = True) -> TrainSharding:
    """The plan for training ``cfg`` on ``mesh`` (default: the host mesh
    over the process group): ``table`` (default: the production rules
    table), the reference's param specs and, with ``zero1`` (the
    dry-run's ``--no-zero1`` turns it off), the moments split over the
    data axes."""
    mesh = mesh if mesh is not None else make_host_mesh()
    if table is None:
        table = shd.production_rules_table("pod" in mesh.axis_names)
    pshape = params_specs(cfg)
    with shd.axis_rules(mesh, table) as rules:
        layout = shd.param_pspecs(pshape, rules)
    olayout = opt_state_pspecs(layout, pshape, mesh) if zero1 else layout
    return TrainSharding(mesh=mesh, table=table, cfg=cfg,
                         param_layout=layout, opt_layout=olayout)


def create(params, optimizer: Optimizer, plan: TrainSharding) -> dict:
    """The train state of this rank's param blocks ``params``
    (``plan.shard_params``): each a leaf that requires grad, the moments
    at their ``opt_layout`` blocks."""
    for p in leaves(params):
        p.requires_grad_(True)
    blocks = shd.tree_map_with_path(
        lambda path, p: plan.zero_block(path, p.detach()), params)
    return {"params": params, "opt": optimizer.init(blocks), "step": 0}


def _scored(cfg, batch) -> torch.Tensor:
    """The positions the loss averages over in ``batch`` (f32 0-d): its
    mask's sum, else every label (a VLM's text positions,
    ``transformer.loss_fn``)."""
    mask = batch.get("loss_mask")
    labels = batch["labels"]
    if mask is not None:
        return mask.float().sum()
    b, s = labels.shape
    if cfg.family == "vlm":
        s = max(s - cfg.n_patches, 0)
    return torch.tensor(float(b * s), device=labels.device)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    plan: TrainSharding):
    """(state, batch) -> (state, metrics), ``state`` from ``create`` and
    ``batch`` this rank's rows (``plan.local_batch``): the module
    docstring's five steps, updating the state in place. ``metrics``:
    ``loss`` (the global batch's) and ``grad_norm`` as 0-d tensors, the
    same on every rank; with ``keep_grads=True`` also ``grads``, the
    gradients at this rank's ``opt_layout`` blocks before the clip."""
    if plan.mesh.device_mesh is not None and plan.cfg.family != "dense":
        raise NotImplementedError(
            f"sharded training of the {plan.cfg.family} family: the dense "
            "family only (ROADMAP A19)")
    data = plan.data_axes
    paths = []
    shd.tree_map_with_path(lambda path, _: paths.append(path),
                           plan.param_layout)
    # each leaf's share of its block's sum of squares, in ``leaves`` order
    share = list(leaves(shd.tree_map_with_path(
        lambda path, _: 1.0 / plan.copies(path), plan.param_layout)))

    def norm_reduce(sq):
        """Each block's sum of squares once over the mesh."""
        local = sum(w * x for w, x in zip(share, sq))
        return shd.reduce_over(shd.reduce_over(local, "model"), data)

    def sync(path, g):
        d = plan.zero_dim(path)
        if d is None:
            return shd.reduce_over(g, data)
        return shd.reduce_scatter_over(g, d, data)

    def train_step(state, batch, keep_grads: bool = False):
        params = state["params"]
        with plan.rules():
            loss = loss_fn(params, batch)
            scored = _scored(plan.cfg, batch).to(loss.device)
            total = loss.detach() * scored.clamp(min=1.0)
            sums = shd.reduce_over(torch.stack([total, scored]), data)
            count = sums[1].clamp(min=1.0)
            (loss * scored.clamp(min=1.0) / count).backward()
            grads = shd.tree_map_with_path(
                lambda path, p: sync(path, p.grad if p.grad is not None
                                     else torch.zeros_like(p)), params)
            for p in leaves(params):
                p.grad = None
            kept = (tree_map(lambda g: g.clone(), grads) if keep_grads
                    else None)
            blocks = shd.tree_map_with_path(
                lambda path, p: plan.zero_block(path, p.detach()), params)
            gnorm = optimizer.update(grads, state["opt"], blocks,
                                     state["step"], norm_reduce=norm_reduce)
            with torch.no_grad():
                for path in paths:
                    d = plan.zero_dim(path)
                    if d is not None and plan.data_ranks > 1:
                        p = shd.leaf_at(params, path)
                        p.copy_(shd.gather_over(shd.leaf_at(blocks, path),
                                                d, data))
        state["step"] += 1
        metrics = {"loss": sums[0] / count, "grad_norm": gnorm}
        if keep_grads:
            metrics["grads"] = kept
        return state, metrics

    return train_step
