"""Multi-rank solves of graph energies by explicit SPMD over
``torch.distributed`` (counterpart of ``thallo_tpu/parallel/mesh.py``).

JAX annotates placements and lets XLA's SPMD partitioner insert the
collectives.  PyTorch has no partitioner for the port's kernels, so
here one process per rank runs the same step on its own device and the
step issues every collective itself (parallel/comm.py):

* **who owns what** (JAX's placement rules, ``mesh.py:139-164``): an
  unknown whose dim is mapped to the mesh axis, and divisible by its
  size, is owned in contiguous blocks along that dim; otherwise every
  rank holds all of it (replicated).  The plan's unknowns and the solver
  state over them (``_U``, the PCG vectors, −JᵀF, diag(JᵀJ), the
  block-Jacobi inverses) are the rank's owned shards;
* **residuals**: a group whose external domain is mapped evaluates the
  rank's contiguous block of it (``LoweredGroup.shard_view``: local
  residual ids, global element ids).  The block follows the owners of a
  slot's image where the slot's owners never decrease along the domain
  (a sorted map, ``sort_edges_by_owner``, or a pointwise access): rank r
  then evaluates the residuals of the elements it owns, and that slot's
  row tables cover its owned rows alone (solver/blocksparse.py's
  windows).  Otherwise the domain splits into equal blocks.  A group
  whose domains are all unmapped is evaluated whole on every rank;
* **what moves, per step**: U and each PCG direction are gathered
  (``all_gather``) before the gathers of the residuals read them; the
  partial per-unknown sums of the sharded groups (−JᵀF, diag, the
  block-Jacobi blocks, JᵀJ·p) go to their owners by ``reduce_scatter``,
  or stay put where every contribution of this rank lies in its own
  block (the image is *local-complete*), and a replicated image's sums
  by one ``all_reduce`` of the image; dots and costs are partial sums
  (a replicated image counted on rank 0 alone) combined by one
  ``all_reduce`` of the scalars a step computes together.  A small
  problem's dense JᵀJ is summed by one ``all_reduce`` of the [K, K]
  matrix.  Every decision of a step (LM's accept, the stops) reads only
  all-reduced scalars, so the ranks cannot diverge.

Only one mesh axis may have more than one rank, and the mesh must span
the default process group.  Outside this slice, refused here with the
ROADMAP item named: grid energies (a stencil slot: halo exchange) and
contractions, Exclude masks, ``linear_solver`` ``schur_dense`` and
``direct`` and a second mesh axis (all item 10b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm

TODO_GRID = "ROADMAP queue 1, item 10b"


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def mesh_shape(n: int, axis_names=("x",), shape=None) -> Tuple[int, ...]:
    """JAX's factorization (``mesh.py:28-44``): one axis takes all n; two
    axes the most square split, larger first (8 -> (4, 2))."""
    if shape is not None:
        if int(np.prod(shape)) != n or len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} ranks on "
                             f"{len(axis_names)} axes")
        return tuple(int(s) for s in shape)
    if len(axis_names) == 1:
        return (n,)
    if len(axis_names) == 2:
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        return (max(a, n // a), min(a, n // a))
    raise ValueError("give an explicit mesh shape for >2 axes")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks of the default process group laid out on named axes (JAX's
    Mesh over devices).  ``ranks`` is the grid of global ranks; ``shape``
    maps each axis name to its size, as JAX's ``mesh.shape``."""

    axis_names: Tuple[str, ...]
    ranks: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)


def make_mesh(n_devices: Optional[int] = None, axis_names=("x",), shape=None) -> Mesh:
    """A mesh over the first n_devices ranks of the default process group
    (all of them by default), shaped as JAX's make_mesh shapes it.  With
    no process group, a mesh of the one process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n > world:
        raise ValueError(f"a mesh of {n} ranks, but the process group has {world}")
    return Mesh(tuple(axis_names), np.arange(n).reshape(mesh_shape(n, axis_names, shape)))


# ---------------------------------------------------------------------------
# the solver's view of a sharded plan
# ---------------------------------------------------------------------------
class ShardCtx:
    """What CompiledSolver needs of a sharded plan (its ``shard_ctx``): the
    rank's owned block of each unknown (None: replicated), which groups
    are sharded, which owned images are local-complete, and the
    collectives that bring partial sums to their owners."""

    def __init__(self, unknowns, owned, sharded, windows, device, dtype):
        self.names = [im.name for im in unknowns]  # in the spec's order
        self.dims = {im.name: tuple(d.size for d in im.dims) for im in unknowns}
        self.channels = {im.name: im.channels for im in unknowns}
        self.owned = dict(owned)           # name -> (dim, lo, hi) or None
        self.sharded = list(sharded)       # per solver group
        self.complete = set()              # owned images whose partial sums stay put
        self.windows = dict(windows)       # name -> [lo, hi) of owned elements (dim 0)
        self.device, self.dtype = device, dtype
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()

    # -- one image ---------------------------------------------------------
    def shard(self, name, full):
        """The rank's block of an image-shaped tensor (a view)."""
        o = self.owned.get(name)
        if o is None:
            return full
        d, lo, hi = o
        return full.narrow(d, lo, hi - lo)

    def gather(self, name, v):
        """The whole image from the owned shards (replicated: v itself)."""
        o = self.owned.get(name)
        if o is None:
            return v
        d = o[0]
        full = comm.all_gather(v.movedim(d, 0))
        return full.movedim(0, d) if d else full

    def own(self, name, part=None, full=None):
        """The rank's shard of the sum over the ranks of `part` (partial
        sums of the sharded groups, whole-image) plus `full` (complete
        sums, whole-image)."""
        out = None
        if part is not None:
            o = self.owned.get(name)
            if o is None:
                out = comm.all_reduce(part.contiguous())
            elif name in self.complete:
                out = self.shard(name, part)
            else:
                d = o[0]
                out = comm.reduce_scatter(part.movedim(d, 0))
                out = out.movedim(0, d) if d else out
        if full is not None:
            f = self.shard(name, full)
            out = f if out is None else out + f
        return out

    # -- trees of images ---------------------------------------------------
    def gather_tree(self, t):
        return {k: self.gather(k, v) for k, v in t.items()}

    def own_tree(self, part, full):
        """own() of every unknown image, in the spec's order (the same
        collectives in the same order on every rank); an image in neither
        tree gets zeros."""
        out = {}
        for k in self.names:
            if k in part or k in full:
                out[k] = self.own(k, part.get(k), full.get(k))
            else:
                shape = list(self.dims[k]) + [self.channels[k]]
                o = self.owned.get(k)
                if o is not None:
                    shape[o[0]] = o[2] - o[1]
                out[k] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        return out

    def own_blocks(self, name, part=None, full=None):
        """own() of per-element blocks stored channel-major [F, N] (the
        block-Jacobi blocks), N the image's elements."""
        def as_image(b):
            return None if b is None else b.T.reshape(self.dims[name] + (b.shape[0],))

        out = self.own(name, as_image(part), as_image(full))
        return out.reshape(-1, out.shape[-1]).T

    def all_reduce(self, t):
        """t summed over the ranks (a small problem's dense JᵀJ)."""
        return comm.all_reduce(t.contiguous())

    # -- scalars -----------------------------------------------------------
    def allsum(self, *xs):
        """The scalars xs summed over the ranks, by one all_reduce."""
        t = comm.all_reduce(torch.stack([x.reshape(()) for x in xs]))
        return tuple(t.unbind(0))

    def local_dot(self, a, b):
        """This rank's part of the dot of two unknown trees: owned shards,
        and the replicated images on rank 0 alone (counted once)."""
        total = None
        for k in a:
            if self.owned.get(k) is None and self.rank != 0:
                continue
            d = torch.dot(a[k].reshape(-1), b[k].reshape(-1))
            total = d if total is None else total + d
        if total is None:
            total = torch.zeros((), dtype=next(iter(a.values())).dtype, device=self.device)
        return total

    def counts_cost(self, gi) -> bool:
        """Whether this rank adds group gi's residuals to a cost: a sharded
        group on every rank (its block), an unsharded one on rank 0."""
        return self.sharded[gi] or self.rank == 0


# ---------------------------------------------------------------------------
# sharding a plan
# ---------------------------------------------------------------------------
def _resolve_axes(spec, mesh, dim_axes):
    """dim name -> mesh axis name, with JAX's default (the first declared
    dim on the first axis, the second on the second)."""
    if dim_axes is None:
        dim_axes = {d.name: ax for d, ax in zip(spec.dims, mesh.axis_names)}
    out = {}
    for k, v in dim_axes.items():
        out[k] = mesh.axis_names[v] if isinstance(v, int) else v
        if out[k] not in mesh.axis_names:
            raise ValueError(f"dim_axes[{k!r}] = {v!r} names no axis of the mesh "
                             f"{mesh.axis_names}")
    return out


def _check_plan(plan, mesh):
    """Refuse what this slice does not shard, and a backend that does not
    suit the plan's device."""
    if not dist.is_initialized():
        raise ValueError("shard_plan_inputs needs torch.distributed: join the ranks first "
                         "(parallel.multihost.initialize, or init_process_group)")
    if mesh.size != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size} ranks, the process group "
                         f"{dist.get_world_size()}: a mesh must span every rank")
    busy = [a for a, n in mesh.shape.items() if n > 1]
    if len(busy) > 1:
        raise NotImplementedError(f"a mesh with more than one axis of several ranks "
                                  f"({mesh.shape}) ({TODO_GRID})")
    backend = str(dist.get_backend())
    want = "nccl" if plan.device.type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a plan on {plan.device} shards over the {want!r} backend; the "
                         f"process group runs {backend!r} (the backend is never swapped)")
    comp = plan.compiled
    groups = comp._global_groups or comp.groups
    if comp.schur_dense or comp.direct_solve:
        kind = "schur_dense" if comp.schur_dense else "direct"
        raise NotImplementedError(f"linear_solver={kind!r} under a mesh ({TODO_GRID})")
    if any(im.exclude_expr is not None for im in plan.spec.unknowns):
        raise NotImplementedError(f"Exclude masks under a mesh ({TODO_GRID})")
    for gp in groups:
        g = gp.group
        if g.con_domains or g.con_block is not None:
            raise NotImplementedError(f"group {gp.name!r} has contractions: sharding it "
                                      f"waits for {TODO_GRID}")
        rolls = [rp for rp in g._rolls + g._crolls + g._mrolls if rp is not None]
        if any(any(rp[1]) for rp in rolls):
            raise NotImplementedError(f"group {gp.name!r} has stencil slots: their halo "
                                      f"exchange waits for {TODO_GRID}")


def _owned_blocks(spec, mesh, name_axes):
    """image name -> (dim, [lo, hi) of each rank) of each unknown owned
    along a mapped, divisible dim (JAX's place_image); absent:
    replicated."""
    out = {}
    for im in spec.unknowns:
        for i, d in enumerate(im.dims):
            ax = name_axes.get(d.name)
            if ax is not None and d.size % mesh.shape[ax] == 0:
                n = mesh.shape[ax]
                b = d.size // n
                out[im.name] = (i, [(r * b, (r + 1) * b) for r in range(n)])
                break
    return out


def _element_coord(im, dim, flat):
    """The coordinate along `dim` of flat element ids of image im."""
    sizes = [d.size for d in im.dims]
    stride = int(np.prod(sizes[dim + 1:])) if dim + 1 < len(sizes) else 1
    return (flat // stride) % sizes[dim]


def _domain_splits(groups, gin, name_axes, mesh, owned):
    """Each mapped external dim's split into the ranks' blocks, [n + 1]
    bounds: at the owners of a slot whose owners never decrease along the
    dim (the first such slot of the first group over it), else equal
    blocks.  Also returns, per group, its sharded axis (or None)."""
    splits, axis_of = {}, []
    for gp in groups:
        g = gp.group
        ax = next((a for a, dom in enumerate(g.ext_domains)
                   if name_axes.get(dom.dim.name) is not None), None)
        axis_of.append(ax)
        if ax is None:
            continue
        dname = g.ext_domains[ax].dim.name
        n = mesh.shape[name_axes[dname]]
        size = g.ext_shape[ax]
        if size < n:
            raise ValueError(f"dim {dname} has {size} elements, fewer than the {n} ranks")
        if dname in splits:
            continue
        bounds = None
        if len(g.ext_shape) == 1:
            for s in g.jac_slots:
                own = owned.get(s.image.name)
                if own is None or s.dep_cons:
                    continue
                dim, blocks = own
                if name_axes.get(s.image.dims[dim].name) != name_axes[dname]:
                    continue
                flat = g._slot_flat_indices(s, gin).astype(np.int64)
                owner = _element_coord(s.image, dim, flat) // (blocks[0][1] - blocks[0][0])
                if np.all(np.diff(owner) >= 0):
                    b = np.searchsorted(owner, np.arange(n + 1), side="left")
                    if np.all(np.diff(b) > 0):
                        bounds = b
                        break
        if bounds is None:
            bounds = np.cumsum([0] + [len(c) for c in np.array_split(np.arange(size), n)])
        splits[dname] = np.asarray(bounds, dtype=np.int64)
    return splits, axis_of


def bind_sharded(plan, gin):
    """Bind the plan's global normalized inputs `gin` under its mesh: the
    ranks' residual blocks and local groups, the prepared tables of this
    rank's shard (built from the global inputs, then kept), the solver's
    ShardCtx, and `plan._inputs` as this rank's view (owned blocks of the
    unknowns, the residual blocks of the arrays and sparse maps over a
    split dim, everything else whole)."""
    comp, spec, mesh = plan.compiled, plan.spec, plan.mesh
    name_axes = plan._dim_axes
    rank = dist.get_rank()
    owned_all = _owned_blocks(spec, mesh, name_axes)
    if comp._global_groups is None:
        comp._global_groups = list(comp.groups)
    splits, axis_of = _domain_splits(comp._global_groups, gin, name_axes, mesh, owned_all)
    local, sharded = [], []
    for gp, ax in zip(comp._global_groups, axis_of):
        if ax is None:
            local.append(gp)
            sharded.append(False)
            continue
        b = splits[gp.group.ext_domains[ax].dim.name]
        local.append(dataclasses.replace(
            gp, group=gp.group.shard_view(ax, int(b[rank]), int(b[rank + 1]))))
        sharded.append(True)
    comp.groups = local
    owned = {im.name: None for im in spec.unknowns}
    windows = {}
    for name, (dim, blocks) in owned_all.items():
        lo, hi = blocks[rank]
        owned[name] = (dim, lo, hi)
        if dim == 0:
            im = next(u for u in spec.unknowns if u.name == name)
            inner = int(np.prod([d.size for d in im.dims[1:]])) if len(im.dims) > 1 else 1
            windows[name] = (lo * inner, hi * inner)
    ctx = ShardCtx(spec.unknowns, owned, sharded, windows, plan.device, plan.dtype)
    comp.shard_ctx = ctx
    prep = comp.prepare(gin)
    # the ranks must have taken the same table decisions (the collectives
    # of a step follow them), and an owned image is local-complete when no
    # rank's sharded groups touch it outside that rank's block
    built = [int(c["bsr"] is not None) for c in prep["consts"]]
    if not comm.agree(built, plan.device):
        raise ValueError("the ranks built block-sparse tables for different groups (a rank's "
                         "residual block is too small for its tables); shard fewer ranks")
    flags = []
    names = [n for n in ctx.names if owned[n] is not None]
    for name in names:
        dim, lo, hi = owned[name]
        ok = True
        for gp, sh, c in zip(local, sharded, prep["consts"]):
            if not sh:
                continue
            g = gp.group
            for s in g.jac_slots:
                if s.image.name != name:
                    continue
                flat = g._slot_flat_indices(s, gin).astype(np.int64)
                coord = _element_coord(s.image, dim, flat)
                ok = ok and bool(flat.size == 0 or (coord.min() >= lo and coord.max() < hi))
        flags.append(int(ok))
    agreed = comm.all_min(flags, plan.device) if names else []
    ctx.complete = {n for n, f in zip(names, agreed) if f}
    plan._prep = prep
    view = {}
    for k, v in gin.items():
        if k in owned:
            view[k] = ctx.shard(k, v).clone()
            continue
        first = _first_dim(spec, k)
        if first is not None and first in splits and hasattr(v, "shape"):
            b = splits[first]
            view[k] = v[int(b[rank]):int(b[rank + 1])]
        else:
            view[k] = v
    return view


def _first_dim(spec, name):
    for im in spec.arrays:
        if im.name == name:
            return im.dims[0].name if im.dims else None
    for sm in spec.sparse_maps:
        if sm.name == name:
            return sm.in_dims[0].name if len(sm.in_dims) == 1 else None
    return None


def shard_bsr_tables(plan):
    """The GroupBsr of each block-sparse group of a sharded plan, as this
    rank holds them: built on its residual block, a row table over the
    owned rows where its index array stays inside them (the counterpart of
    JAX's row-block placement of the tables, ``mesh.py:55-102``)."""
    return [c["bsr"] for c in plan._prep["consts"] if c.get("bsr") is not None]


def shard_plan_inputs(plan, mesh: Mesh, dim_axes: Dict[str, str] = None):
    """Shard a bound plan over the mesh (JAX's ``shard_plan_inputs``,
    ``mesh.py:105-221``, whose dim_axes it takes: dim name -> axis name,
    default the first declared dim on the first axis, the second on the
    second).  Every rank calls it with the same global inputs bound.  The
    unknowns restart from their bound values, as JAX's do; the LM state
    is kept.  Raises NotImplementedError for what waits for item 10b and
    ValueError for a backend that does not suit the plan's device."""
    if plan._inputs is None:
        raise RuntimeError("call init() before shard_plan_inputs()")
    _check_plan(plan, mesh)
    gin = plan._inputs if plan.mesh is None else plan._global_inputs()
    plan.mesh = mesh
    plan._dim_axes = _resolve_axes(plan.spec, mesh, dim_axes)
    plan._bind(gin)
    plan._U = {im.name: plan._inputs[im.name].clone() for im in plan.spec.unknowns}
    if plan._lm is not None:
        ctx = plan.compiled.shard_ctx
        plan._lm = plan._lm._replace(ssq={k: ctx.shard(k, v).clone()
                                          for k, v in plan._lm.ssq.items()})
    return plan


# ---------------------------------------------------------------------------
# distribution evidence
# ---------------------------------------------------------------------------
def step_collectives(plan):
    """The collectives of one step of the plan (the counterpart of JAX's
    ``compiled_step_hlo``): one step on copies of its state, with the
    recorder on; the plan's state is unchanged.  Returns [(kind, bytes of
    the per-rank result)]."""
    comp = plan.compiled
    U = {k: v.clone() for k, v in plan._U.items()}
    with comm.recording() as rec:
        comp.nonlinear_step(U, plan._lm, plan._step_inputs(), plan._sp(), plan._prep)
    return list(rec)


def collective_stats(record):
    """JAX's keys (``mesh.py:233-272``) from a step's record: counts per
    kind and the bytes of the per-rank results.  A halo permute would count
    as collective_permute; this slice makes none."""
    out = {k: 0 for k in ("collective_permute", "all_reduce", "all_gather",
                          "reduce_scatter", "all_to_all")}
    for k in ("all_gather", "all_reduce", "collective_permute", "reduce_scatter"):
        out[k + "_bytes"] = 0
    for kind, nbytes in record:
        out[kind] += 1
        out[kind + "_bytes"] += nbytes
    return out


def distribution_report(plan):
    """Per unknown (JAX's keys, ``mesh.py:275-292``), of this rank's shard:
    the global shape, the ranks of the mesh, the shard's shape, whether the
    image is replicated, and the shard's bytes."""
    ctx = plan.compiled.shard_ctx
    out = {}
    for name, v in plan._U.items():
        o = ctx.owned.get(name) if ctx else None
        gshape = tuple(v.shape)
        if o is not None:
            d, lo, hi = o
            gshape = gshape[:d] + (v.shape[d] * ctx.size,) + gshape[d + 1:]
        out[name] = {
            "global_shape": gshape,
            "n_devices": plan.mesh.size if plan.mesh is not None else 1,
            "shard_shapes": [tuple(v.shape)],
            "replicated": o is None,
            "bytes_per_device": int(v.numel() * v.element_size()),
        }
    return out


def sort_edges_by_owner(inputs, spec, edge_dim_name: str, owner_map_name: str,
                        n_shards: int):
    """Permute the edge/observation domain so edges are contiguous by the
    owning shard of `owner_map_name`'s target vertex (edge-partition
    locality: per-shard scatters stay mostly local instead of reducing
    across every shard).  Residual sums are permutation-invariant, so this
    never changes results — it only changes communication.  Returns (new
    inputs dict, permutation).  (A copy of thallo_tpu's, numpy only.)"""
    sm = next(s for s in spec.sparse_maps if s.name == owner_map_name)
    if len(sm.in_dims) != 1 or sm.in_dims[0].name != edge_dim_name:
        raise ValueError(f"{owner_map_name} is not a 1-D map over {edge_dim_name}")
    owner = np.asarray(inputs[owner_map_name]).reshape(-1)
    sizes = [d.size for d in sm.out_dims]
    n_owner = (int(np.prod(sizes)) if all(s is not None for s in sizes)
               else int(owner.max()) + 1)
    shard_of = (owner.astype(np.int64) * n_shards) // max(n_owner, 1)
    order = np.argsort(shard_of, kind="stable")
    new_inputs = dict(inputs)
    for s in spec.sparse_maps:
        if len(s.in_dims) == 1 and s.in_dims[0].name == edge_dim_name:
            new_inputs[s.name] = np.asarray(inputs[s.name])[order]
    for im in spec.arrays:
        if im.dims and im.dims[0].name == edge_dim_name:
            new_inputs[im.name] = np.asarray(inputs[im.name])[order]
    for im in spec.unknowns:
        if im.dims and im.dims[0].name == edge_dim_name:
            new_inputs[im.name] = np.asarray(inputs[im.name])[order]
    return new_inputs, order

