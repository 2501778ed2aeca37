"""Sharding vocabulary and helpers on a ``torch.distributed`` DeviceMesh:
the counterpart of ``repro.distributed.sharding``.

Mesh axes (see ``launch/mesh.py``):
  * ``pod``   -- outer data-parallel axis across pods (multi-pod mesh only)
  * ``data``  -- data parallel / FSDP axis within a pod
  * ``model`` -- tensor-parallel axis

As in the reference, a tensor's sharding is a spec tuple: one entry per
tensor dim, each None, a mesh axis name or a tuple of names. On a
DeviceMesh a spec becomes DTensor placements, one per mesh dim
(:func:`spec`): ``Shard(i)`` on each mesh dim that entry i names,
``Replicate()`` on the others. Axes missing from the mesh are dropped
(:func:`filter_spec`); a mesh dim of size 1 is ``Replicate()``, which is
the same layout. Where one entry names several axes, the tensor dim is
split by them in mesh order, as the reference's major-to-minor order.

The active mesh is the one installed by :func:`use_mesh` (the reference's
``set_mesh``); :func:`shard_hint` and :func:`constrain_like` are the
identity without one. The model code computes on plain tensors: a hint
on a plain tensor is the identity too, and a DTensor is redistributed to
the hint. The train step gathers each parameter before the forward
(``train/train_step.py``): whole (:func:`gather`), or, where the family
computes on ``model`` shards, over the batch axes only
(:func:`gather_batch`). The serving step computes on each rank's local
shards and calls the decode collectives (:func:`all_gather`,
:func:`all_reduce_sum`, :func:`all_reduce_max`), which carry no gradient;
the training forward on shards calls the autograd collectives
(:func:`copy_to_model`, :func:`reduce_from_model`,
:func:`gather_from_model`, :func:`slice_for_model`), whose backward is
each one's adjoint.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard)

BATCH_AXES = ("pod", "data")    # batch dim shards over both DP axes
TP_AXIS = "model"

# --- activation (sequence-parallel) sharding policy -------------------------
# When set to a mesh axis name (usually "model"), the residual stream h is
# hinted to be sharded along its sequence dim between blocks.
_ACT_SEQ_AXIS: list = [None]


class activation_sharding:
    """Context manager selecting the sequence-parallel axis."""

    def __init__(self, axis):
        self.axis = axis

    def __enter__(self):
        _ACT_SEQ_AXIS.append(self.axis)
        return self

    def __exit__(self, *exc):
        _ACT_SEQ_AXIS.pop()
        return False


def act_seq_axis():
    return _ACT_SEQ_AXIS[-1]


def hint_residual(h):
    """Sharding hint for the residual stream (b, s, d) between blocks."""
    if h.ndim != 3 or h.shape[1] <= 1:
        return shard_hint(h, BATCH_AXES, None, None)
    return shard_hint(h, BATCH_AXES, act_seq_axis(), None)


# --- the active mesh --------------------------------------------------------

_ACTIVE_MESH: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Install `mesh` as the active mesh inside the ``with`` block."""
    _ACTIVE_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.pop()


def active_mesh():
    """The mesh installed by the innermost :func:`use_mesh`, or None."""
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# --- specs ------------------------------------------------------------------

def filter_spec(entries: tuple, axis_names: tuple) -> tuple:
    """Drop mesh axes that are not present on the mesh."""
    out = []
    for e in entries:
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in axis_names)
            out.append(kept if kept else None)
        else:
            out.append(e if e in axis_names else None)
    return tuple(out)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(mesh, entries: tuple) -> tuple:
    """DTensor placements, one per dim of `mesh`, of a tensor whose dim i
    is split over the mesh axes that entries[i] names. Axes missing from
    the mesh are ignored; a mesh dim of size 1 is Replicate. An axis named
    by two entries raises."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    seen: set = set()
    for dim, e in enumerate(entries):
        for a in _axes(e):
            if a not in names:
                continue
            if a in seen:
                raise ValueError(f"mesh axis {a!r} used twice in {entries}")
            seen.add(a)
            m = names.index(a)
            if mesh.shape[m] > 1:
                out[m] = Shard(dim)
    return tuple(out)


def spec(mesh, *entries) -> tuple:
    """The placements on `mesh` of the spec `entries`, axes the mesh lacks
    dropped (the reference's ``spec``, which returns a PartitionSpec for
    the active mesh). A pure function of its arguments."""
    return placements(mesh, filter_spec(entries, tuple(mesh.mesh_dim_names)))


def _entry_ok(e, dim: int, sizes: dict):
    """The axes of entry `e` that divide a dim of size `dim`: axes missing
    from the mesh dropped, then leading axes dropped until the product of
    the sizes divides `dim`."""
    axes = [a for a in _axes(e) if a in sizes]
    while axes:
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if dim % prod == 0:
            break
        axes.pop(0)
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def constrain_entries(spec_: tuple, shape: tuple, sizes: dict) -> tuple:
    """The reference's ``constrain_like`` rule for one leaf: the spec
    padded with None to the leaf's rank, each entry cut to the axes that
    divide its dim (:func:`_entry_ok`), and no mesh axis used by two
    entries (a later entry loses it)."""
    spec_ = tuple(spec_) + (None,) * (len(shape) - len(spec_))
    used: set = set()
    entries = []
    for e, d in zip(spec_, shape):
        c = None if e is None else _entry_ok(e, d, sizes)
        if c is not None:
            cs = c if isinstance(c, tuple) else (c,)
            cs = tuple(a for a in cs if a not in used)
            used.update(cs)
            c = cs if len(cs) > 1 else (cs[0] if cs else None)
        entries.append(c)
    return tuple(entries)


def is_spec(x) -> bool:
    """A spec tuple (a leaf of a specs tree), as the reference tests."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, tuple, list, type(None))) for e in x)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of nested dicts and NamedTuples
    whose specs tree has the same structure, spec tuples at the leaves; a
    subtree whose spec is None is left as it is."""
    if specs is None:
        return tree
    if is_spec(specs):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, t, s)
                            for t, s in zip(tree, specs)))
    raise TypeError(f"no spec for a {type(tree).__name__} leaf")


# --- placing tensors on a mesh ----------------------------------------------

def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (its storage), a plain tensor as
    is."""
    return x.to_local() if isinstance(x, DTensor) else x


def local_tree(tree):
    """A tree of nested dicts and NamedTuples with each DTensor leaf
    replaced by its local shard."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(local_tree(t) for t in tree))
    return local(tree)


def gather(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor: a DTensor gathered over its mesh (its own storage
    when every placement is Replicate), a plain tensor as is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local_shard(full: torch.Tensor, mesh, places: tuple) -> torch.Tensor:
    """This rank's shard under `places` of a tensor every rank holds
    whole: no communication. Mesh dims split in order, each into equal
    parts; a dim that does not divide raises."""
    coord = mesh.get_coordinate()
    out = full
    for m, p in enumerate(places):
        if isinstance(p, Shard):
            n = mesh.shape[m]
            if out.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of a {tuple(full.shape)} "
                                 f"tensor does not split over {n} ranks of "
                                 f"mesh axis {mesh.mesh_dim_names[m]!r}")
            out = out.chunk(n, p.dim)[coord[m]]
    return out if out is full else out.contiguous().clone()


def like(ref: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`x`, a local shard, as a DTensor placed like `ref`; `x` as is when
    `ref` is a plain tensor."""
    if not isinstance(ref, DTensor):
        return x
    return DTensor.from_local(x, ref.device_mesh, ref.placements,
                              run_check=False)


def place(x: torch.Tensor, mesh, places: tuple) -> torch.Tensor:
    """`x` as a DTensor on `mesh` under `places`: a plain tensor (the same
    on every rank) is cut locally, a DTensor on `mesh` redistributed
    (itself where its placements are these)."""
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            if tuple(x.placements) == tuple(places):
                return x
            return x.redistribute(mesh, places)
        x = x.full_tensor()
    return DTensor.from_local(local_shard(x, mesh, places), mesh, places,
                              run_check=False)


def shard_hint(x: torch.Tensor, *entries) -> torch.Tensor:
    """Identity with no active mesh or on a plain tensor; a DTensor is
    redistributed to the hint, axes the mesh lacks dropped."""
    mesh = active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return place(x, mesh, spec(mesh, *entries))


def constrain_like(tree, specs, mesh=None):
    """Every leaf placed on the active mesh (or `mesh`) under its spec
    tuple, filtered to the mesh and to divisibility by the reference's
    rule (:func:`constrain_entries`). No-op outside a mesh. The train step
    keeps parameters, moments and the gradient accumulator so (ZeRO over
    ``data`` with ``fsdp="data"``, tensor-parallel storage over
    ``model``)."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return tree
    sizes = mesh_axis_sizes(mesh)
    return map_specs(lambda x, s: place(x, mesh, placements(
        mesh, constrain_entries(s, tuple(x.shape), sizes))), tree, specs)


# --- the data axes ----------------------------------------------------------

def _dims(mesh, axes) -> list:
    names = tuple(mesh.mesh_dim_names)
    return [names.index(a) for a in axes if a in names]


def data_rows(mesh) -> tuple[int, int]:
    """(index, count): this rank's place among the ranks that split the
    batch (the mesh's ``pod`` and ``data`` axes, pod major); (0, 1) with
    no mesh."""
    if mesh is None or not _dims(mesh, BATCH_AXES):
        return 0, 1
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for m in _dims(mesh, BATCH_AXES):
        index = index * mesh.shape[m] + coord[m]
        count *= mesh.shape[m]
    return index, count


def batch_mesh(mesh):
    """The sub-mesh of `mesh`'s batch axes that hold several ranks (its
    rows' coordinates are theirs), or None where there are none: the mesh
    a forward on whole parameters gets where something it computes spans
    the rows of several ranks (the MoE family's routing groups)."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names[m] for m in _dims(mesh, BATCH_AXES)
                  if mesh.shape[m] > 1)
    return mesh[names] if names else None


def batch_rows(batch: int, mesh) -> tuple[int, int]:
    """(start, stop): this rank's rows of a batch of `batch` rows whose
    dim is split over the batch axes by ``constrain_entries``' rule (axes
    dropped until they divide it), the rows of a rank's coordinates in
    mesh order; every row where no axis divides it or with no mesh."""
    if mesh is None:
        return 0, batch
    entry = constrain_entries((BATCH_AXES,), (batch,),
                              mesh_axis_sizes(mesh))[0]
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for m in _dims(mesh, _axes(entry)):
        index = index * mesh.shape[m] + coord[m]
        count *= mesh.shape[m]
    rows = batch // count
    return index * rows, (index + 1) * rows


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of `x` over the ranks of the mesh axes `axes` (an
    all-reduce over each axis's group in turn, in x's dtype), `x` itself
    where they hold one rank. Under gloo a CUDA `x` is staged through the
    host, as the decode collectives do."""
    for axis in axes:
        group = _group(mesh, axis)
        if group is None:
            continue

        def reduce(t, group=group):
            dist.all_reduce(t, group=group)
            return t

        x = _run(reduce, x, group)
    return x


def model_local_shape(ref: torch.Tensor) -> tuple:
    """The shape of a DTensor `ref` with only its ``model`` placements
    applied: what :func:`gather_batch` gives, and the shape of the
    gradient that a forward on ``model`` shards takes of it."""
    mesh = ref.device_mesh
    shape = list(ref.shape)
    for m in _dims(mesh, (TP_AXIS,)):
        p = ref.placements[m]
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.shape[m]
    return tuple(shape)


def reduce_into(g: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The local shard, placed like the DTensor `ref`, of the sum of `g`
    over the batch axes: each rank's `g` is the whole gradient of its own
    rows. `g` is either the whole leaf's gradient (the step gathered the
    leaf whole) or already this rank's ``model`` shard of it, of
    :func:`model_local_shape` (the step computed on ``model`` shards);
    other shapes raise. A reduce-scatter where a dim of `ref` is split
    over a batch axis, an all-reduce where it is not; a whole `g` is
    sliced on the other axes (their ranks hold the same rows), a shard is
    not sliced again; no communication where the batch axes hold one
    rank."""
    mesh = ref.device_mesh
    src = [Replicate()] * mesh.ndim
    for m in _dims(mesh, BATCH_AXES):
        if mesh.shape[m] > 1:
            src[m] = Partial()
    whole = tuple(g.shape) == tuple(ref.shape)
    if not whole:
        if tuple(g.shape) != model_local_shape(ref):
            raise ValueError(f"reduce_into: a gradient of shape "
                             f"{tuple(g.shape)} for a {tuple(ref.shape)} "
                             f"leaf placed {ref.placements}: neither the "
                             f"leaf's shape nor its model shard's "
                             f"{model_local_shape(ref)}")
        for m in _dims(mesh, (TP_AXIS,)):
            src[m] = ref.placements[m]
    if not any(isinstance(p, Partial) for p in src):
        return local_shard(g, mesh, ref.placements) if whole else g
    return DTensor.from_local(g.float(), mesh, src, run_check=False) \
        .redistribute(mesh, ref.placements).to_local()


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """This rank's ``model`` shard of `x` whole over the batch axes: a
    DTensor split over ``pod`` or ``data`` is gathered there (its other
    placements kept) and its local tensor returned, which is its own
    storage where no batch axis splits it; a plain tensor as is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    batch = _dims(mesh, BATCH_AXES)
    places = tuple(Replicate() if m in batch else p
                   for m, p in enumerate(x.placements))
    if places != tuple(x.placements):
        x = x.redistribute(mesh, places)
    return x.to_local()


def counted_once(x: torch.Tensor) -> bool:
    """Whether this rank's shard of `x` is the one that counts in a sum
    over the mesh: the rank at coordinate 0 of every mesh dim that holds
    copies of it (Replicate of size > 1). True for a plain tensor."""
    if not isinstance(x, DTensor):
        return True
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    return all(coord[m] == 0 for m, p in enumerate(x.placements)
               if isinstance(p, Replicate) and mesh.shape[m] > 1)


# --- collectives of the decode step -----------------------------------------
# On plain local tensors, over the process group of one mesh axis (or of
# several, in turn): the identity, with no op and no copy, where there is
# no mesh, the axis is absent or it holds one rank. Under gloo a CUDA
# tensor is staged through host memory (gloo's collectives are for host
# tensors); the decode step sends at most (b, vocab / model) values at
# once, the gathered logits.

def _group(mesh, axis: str):
    """The process group of mesh axis `axis`, or None where it holds one
    rank or is absent."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return None
    if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return None
    return mesh.get_group(axis)


def model_size(mesh) -> int:
    """Ranks along the ``model`` axis: 1 where it is absent or there is no
    mesh."""
    if mesh is None or TP_AXIS not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(TP_AXIS))


def model_rank(mesh) -> int:
    """This rank's coordinate along the ``model`` axis (0 where absent)."""
    if mesh is None or TP_AXIS not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(TP_AXIS)


def _run(op, x: torch.Tensor, group) -> torch.Tensor:
    """`op`(t) on a copy t of `x` on the group's device, back on x's."""
    if x.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return op(x.cpu()).to(x.device)
    return op(x.clone())


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' `x` along `axes` (a mesh axis or a tuple, major first)
    concatenated along `dim` in rank order."""
    for axis in reversed((axes,) if isinstance(axes, str) else axes):
        group = _group(mesh, axis)
        if group is None:
            continue

        def gather(t, group=group):
            parts = [torch.empty_like(t)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts, dim)

        x = _run(gather, x, group)
    return x


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of the ranks' `x` along `axis`, taken in fp32 (a bf16 `x`
    is rounded once, at the end)."""
    group = _group(mesh, axis)
    if group is None:
        return x

    def reduce(t):
        t = t.float()
        dist.all_reduce(t, group=group)
        return t

    return _run(reduce, x, group).to(x.dtype)


def all_reduce_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise max of the ranks' `x` along `axis`."""
    group = _group(mesh, axis)
    if group is None:
        return x

    def reduce(t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t

    return _run(reduce, x, group)


# --- autograd collectives of the training forward on model shards ----------
# Megatron's column- and row-parallel pair, over the ``model`` axis, on
# plain local tensors: each the identity, with no op and no copy, where
# there is no mesh, the axis is absent or it holds one rank. Under gloo a
# CUDA tensor is staged through the host (``_run``). Each backward is the
# adjoint of its forward, where a tensor every rank holds alike
# (replicated) counts once and one that differs between the ranks
# (partial terms, or shards) counts as the sum over the ranks:
#
#   copy_to_model      replicated -> per rank   back: all-reduce sum
#   reduce_from_model  partial    -> replicated back: identity
#   gather_from_model  shards     -> replicated back: this rank's slice
#   slice_for_model    replicated -> shards     back: all-gather
#   gather_parts_for_model  shards -> per rank  back: scatter, sum, slice
#
# gather_from_model's backward is a slice, not a reduce-scatter: each of
# its callers (the head's logits) feeds the gathered tensor to work that
# every rank on ``model`` does alike (the same loss from the same rows),
# so each rank's incoming gradient is already the whole one. A
# reduce-scatter would count it once per rank.


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of the ranks' `x`, taken in fp32 or wider
    (a bf16 `x` is rounded once, at the end), in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)

    def reduce(t):
        t = t.to(acc)
        dist.all_reduce(t, group=group)
        return t

    return _run(reduce, x, group).to(x.dtype)


def _cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' `x` of `group` concatenated along `dim` in rank order."""
    def gather(t):
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)

    return _run(gather, x, group)


def _slice(x: torch.Tensor, rank: int, n: int, dim: int) -> torch.Tensor:
    """Part `rank` of `n` equal contiguous parts of `x` along `dim`."""
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of a {tuple(x.shape)} tensor does not "
                         f"split over {n} ranks of mesh axis {TP_AXIS!r}")
    size = x.shape[dim] // n
    return x.narrow(dim, rank * size, size).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, n, dim):
        ctx.args = (rank, n, dim)
        return _cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (_slice(g, *ctx.args),) + (None,) * 4


class _SliceForModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, n, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, rank, n, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return (_cat(g, ctx.group, ctx.dim),) + (None,) * 4


class _GatherParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, n, dim, index, width):
        ctx.args = (group, rank, n, dim, index, x.shape[dim], width)
        whole = x if x.shape[dim] == width else _cat(x, group, dim)
        return whole.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        group, rank, n, dim, index, own, width = ctx.args
        shape = list(g.shape)
        shape[dim] = width
        whole = _sum(g.new_zeros(shape).index_add_(dim, index, g), group)
        if own != width:
            whole = _slice(whole, rank, n, dim)
        return (whole,) + (None,) * 6


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Forward `x` itself; backward the all-reduce sum of the gradient over
    ``model``. At the input of each group of column-parallel products
    (and on a replicated leaf that each rank applies to its own part of
    the work), where each rank's gradient holds only its columns'
    terms."""
    group = _group(mesh, TP_AXIS)
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Forward the all-reduce sum over ``model`` (in fp32, as
    :func:`all_reduce_sum`); backward the identity. After each row-parallel
    product and the vocab-parallel embedding lookup."""
    group = _group(mesh, TP_AXIS)
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Forward the ranks' `x` concatenated along `dim` over ``model``;
    backward this rank's slice of the gradient (see the note above)."""
    group = _group(mesh, TP_AXIS)
    if group is None:
        return x
    return _GatherFromModel.apply(x, group, model_rank(mesh),
                                  model_size(mesh), dim % x.dim())


def slice_for_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Forward this rank's contiguous part of a replicated `x` along `dim`
    (``model`` splits it in equal parts); backward the all-gather of the
    parts' gradients, so every rank gets the whole one. For replicated
    leaves that act per head or per channel on activations split over
    ``model``."""
    group = _group(mesh, TP_AXIS)
    if group is None:
        return x
    return _SliceForModel.apply(x, group, model_rank(mesh),
                                model_size(mesh), dim % x.dim())


def gather_parts_for_model(x: torch.Tensor, mesh, dim: int,
                           index: torch.Tensor, width: int) -> torch.Tensor:
    """Forward the entries `index` along `dim` of a tensor `width` long
    there, of which `x` is this rank's equal contiguous part over
    ``model`` (gathered first) or the whole; backward the adjoint: each
    rank's gradient scattered into the whole, summed over ``model``, and
    this rank's part of it (the whole where `x` is whole). For a leaf that
    ``param_specs`` splits evenly but each rank uses by parts of its own
    choosing (zamba2's packed in_proj and conv): where two ranks' indices
    overlap, each one's gradient there is a partial term, summed once."""
    group = _group(mesh, TP_AXIS)
    if group is None:
        return x.index_select(dim, index)
    return _GatherParts.apply(x, group, model_rank(mesh), model_size(mesh),
                              dim % x.dim(), index, width)


# ---------------------------------------------------------------------------
# Padding policies
# ---------------------------------------------------------------------------

def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_heads(n_heads: int, tp: int) -> int:
    """Query heads are padded up to a multiple of TP (vLLM/MaxText
    convention). As in the reference's init, the pad heads' projections
    are drawn like the others (``layers.attn_params``), so they compute."""
    return pad_to_multiple(n_heads, tp)


def padded_kv_heads(n_kv_heads: int, tp: int) -> int:
    """KV heads are *replicated* (not padded) when fewer than TP; the
    parameter tensors keep their true size. For sharding purposes the kv
    projection output dim shards over TP only when divisible."""
    return n_kv_heads


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    """Vocab padded to a lane-aligned multiple (whisper: 51865 -> 51968)."""
    return pad_to_multiple(vocab, multiple)
