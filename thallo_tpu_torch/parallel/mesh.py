"""Multi-rank solves by explicit SPMD over ``torch.distributed``
(counterpart of ``thallo_tpu/parallel/mesh.py``).

JAX annotates placements and lets XLA's SPMD partitioner insert the
collectives (a roll of a sharded image becomes collective-permutes).
PyTorch has no partitioner for the port's kernels, so here one process
per rank runs the same step on its own device and the step issues every
collective itself (parallel/comm.py):

* **who owns what** (JAX's placement rules, ``mesh.py:139-164``): an
  unknown is owned in contiguous blocks along every dim mapped to a mesh
  axis whose size divides it (an axis once an image), by the rank's
  coordinate on that axis; otherwise every rank holds all of it
  (replicated).  The plan's unknowns and the solver state over them
  (``_U``, the PCG vectors, −JᵀF, diag(JᵀJ), the block-Jacobi inverses)
  are the rank's owned blocks;
* **residuals**: a group evaluates the rank's block of each mapped
  external axis (``LoweredGroup.shard_view``: local residual ids, global
  indices).  A one-axis group's block follows the owners of a slot's
  image where the slot's owners never decrease along the domain (a sorted
  map, ``sort_edges_by_owner``, or a pointwise access): rank r then
  evaluates the residuals of the elements it owns, and that slot's row
  tables cover its owned rows alone (solver/blocksparse.py's windows).  A
  grid group's blocks are the owned blocks of the unknowns over its dims,
  so a rank evaluates the residuals at its own pixels.  Otherwise the
  domain splits into equal blocks.  A group whose domains are all
  unmapped is evaluated whole on every rank (counted on rank 0); a busy
  mesh axis that splits none of a group's axes repeats its block, counted
  on the axis's first rank;
* **halo images** (the grid half): an unknown that every group reading it
  reads by affine indices within one neighbour's block of the rank's own
  is read as its halo-extended block: ``halo_exchange`` along each owned
  dim in turn (x, then y on the x-extended block, so the corners come
  along), the halo width of a dim the largest reach of any slot along it
  (stencil offsets, contraction index ranges), agreed at bind time; a
  stencil slot rolls the extended block and takes the block, a gathered
  slot reads it at window indices.  Partial sums over the extended block
  go back by ``halo_reduce``.  Every other owned unknown is read whole
  (``all_gather``; the bind logs why, ``plan._halo_log``);
* **what moves, per step**: halo images exchange slabs with the
  neighbour ranks (``collective_permute``); other owned images are
  gathered (``all_gather``) before the residuals read them and their
  partial sums go to their owners by ``reduce_scatter`` (one owned dim
  over every rank; else ``all_reduce`` and the block), or stay put where
  every contribution of this rank lies in its own block (the image is
  *local-complete*); a replicated image's sums by one ``all_reduce`` of
  the image; dots and costs are partial sums (each element counted on
  one rank) combined by one ``all_reduce`` of the scalars a step computes
  together.  A small problem's dense JᵀJ, the Schur complement of
  ``schur_dense`` and the normal equations of ``direct`` are summed by
  one ``all_reduce`` of the [K, K] matrix and solved on every rank, each
  keeping its owned part.  Every decision of a step (LM's accept, the
  stops) reads only all-reduced scalars, so the ranks cannot diverge.

The mesh must span the default process group, and the backend suit the
plan's device (ValueError).  Constant arrays are not sharded: each rank
binds the slots it reads from the global inputs, halos included, once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..dims import SparseComp
from . import comm



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
class _Discard:
    """The partial sums of a group this rank evaluates but does not count
    (a mesh axis of several ranks that does not split the group: the
    ranks along it hold the same residual block): every value written
    becomes zeros, so each rank still makes the same collectives."""

    def __init__(self, into):
        self.into = into

    def __contains__(self, k):
        return k in self.into

    def __getitem__(self, k):
        return self.into[k]

    def __setitem__(self, k, v):
        if k not in self.into:
            self.into[k] = torch.zeros_like(v)


class ShardCtx:
    """What CompiledSolver needs of a sharded plan (its ``shard_ctx``): the
    rank's owned block of each unknown (None: replicated), how a step
    reads each one (a halo image: its halo-extended block; else the whole
    image), which groups are sharded and counted on this rank, which
    owned images are local-complete, and the collectives that bring
    partial sums to their owners."""

    def __init__(self, unknowns, owned, sharded, windows, device, dtype, counted, halos,
                 rank_blocks, dot_counts, scatter_ok):
        self.names = [im.name for im in unknowns]  # in the spec's order
        self.dims = {im.name: tuple(d.size for d in im.dims) for im in unknowns}
        self.channels = {im.name: im.channels for im in unknowns}
        self.owned = dict(owned)           # name -> ((dim, lo, hi), ...) or None
        self.sharded = list(sharded)       # per solver group
        self.counted = list(counted)       # per group: whether this rank's sums count
        self.complete = set()              # owned images whose partial sums stay put
        self.windows = dict(windows)       # name -> [lo, hi) of owned elements (dim 0)
        self.device, self.dtype = device, dtype
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        # name -> ((dim, h, lower rank, upper rank), ...): the images a step
        # reads as halo-extended blocks, exchanged dim by dim in this order
        self.halos = dict(halos)
        # name -> every rank's ((dim, lo, hi), ...), for the whole image
        self.rank_blocks = dict(rank_blocks)
        # name -> whether this rank counts the image in a dot (an owned
        # block repeated along a mesh axis, or a replicated image, counts
        # on the first rank of the repeat)
        self.dot_counts = dict(dot_counts)
        # owned images whose one owned dim spans every rank, in rank order:
        # their partial sums go to the owners by reduce_scatter
        self.scatter_ok = set(scatter_ok)

    # -- one image ---------------------------------------------------------
    def shard(self, name, full):
        """The rank's block of an image-shaped tensor (a view)."""
        for d, lo, hi in self.owned.get(name) or ():
            full = full.narrow(d, lo, hi - lo)
        return full

    def window(self, name, full):
        """The view a step reads of a whole image-shaped constant (an
        Exclude mask): a halo image's halo-extended block, taken with the
        torus wrap; else the image itself."""
        for d, h, _, _ in self.halos.get(name, ()):
            lo, hi = next((lo, hi) for dd, lo, hi in self.owned[name] if dd == d)
            idx = torch.arange(lo - h, hi + h, device=full.device) % full.shape[d]
            full = full.index_select(d, idx)
        return full

    def whole(self, name, v):
        """The whole image from the owned blocks (replicated: v itself)."""
        o = self.owned.get(name)
        if o is None:
            return v
        if name in self.scatter_ok:
            d = o[0][0]
            full = comm.all_gather(v.movedim(d, 0))
            return full.movedim(0, d) if d else full
        parts = comm.all_gather(v.unsqueeze(0))
        full = v.new_empty(self.dims[name] + (v.shape[-1],))
        for r, blocks in enumerate(self.rank_blocks[name]):
            dst = full
            for d, lo, hi in blocks:
                dst = dst.narrow(d, lo, hi - lo)
            dst.copy_(parts[r])
        return full

    def gather(self, name, v):
        """What a step reads of an unknown from its owned block: a halo
        image's halo-extended block (the halos of one dim after another,
        so the corners come along), else the whole image."""
        if name in self.halos:
            for d, h, lower, upper in self.halos[name]:
                v = comm.halo_exchange(v, d, h, lower, upper)
            return v
        return self.whole(name, v)

    def own(self, name, part=None, full=None):
        """The rank's shard of the sum over the ranks of `part` (partial
        sums of the sharded groups, over the view gather gives) plus `full`
        (complete sums, whole-image)."""
        out = None
        if part is not None:
            o = self.owned.get(name)
            if o is None:
                out = comm.all_reduce(part.contiguous())
            elif name in self.halos:
                out = part
                for d, h, lower, upper in reversed(self.halos[name]):
                    out = comm.halo_reduce(out, d, h, lower, upper)
            elif name in self.complete:
                out = self.shard(name, part)
            elif name in self.scatter_ok:
                d = o[0][0]
                out = comm.reduce_scatter(part.movedim(d, 0))
                out = out.movedim(0, d) if d else out
            else:
                out = self.shard(name, comm.all_reduce(part.contiguous()))
        if full is not None:
            f = self.shard(name, full)
            out = f if out is None else out + f
        return out

    # -- trees of images ---------------------------------------------------
    def _batches(self, names):
        """The halo images among `names` in batches of one exchange (the
        same dims, halos and neighbours: their channels travel together),
        and the other names."""
        batches, rest = {}, []
        for k in names:
            if k in self.halos:
                batches.setdefault(self.halos[k], []).append(k)
            else:
                rest.append(k)
        return list(batches.values()), rest

    def gather_tree(self, t):
        """gather() of every image of t, the halo images of one signature
        in one exchange (their channels concatenated)."""
        batches, rest = self._batches(list(t))
        out = {k: self.gather(k, t[k]) for k in rest}
        for names in batches:
            cs = [t[k].shape[-1] for k in names]
            ext = self.gather(names[0], torch.cat([t[k] for k in names], -1))
            # each image contiguous, as a step without a mesh holds it (a
            # strided view would change the order of later sums)
            out.update(zip(names, (v.contiguous() for v in ext.split(cs, -1))))
        return {k: out[k] for k in t}

    def whole_tree(self, t):
        return {k: self.whole(k, v) for k, v in t.items()}

    def own_tree(self, part, full):
        """own() of every unknown image, in the spec's order (the same
        collectives in the same order on every rank); an image in neither
        tree gets zeros.  Halo images of one signature go back in one
        exchange."""
        out = {}
        present = [k for k in self.names if k in part or k in full]
        batches, rest = self._batches(present)
        for names in batches:
            parts = [k for k in names if k in part]
            if parts:
                shapes = [self._view_shape(k) for k in names]
                cat = torch.cat([part[k] if k in part else
                                 torch.zeros(s, dtype=self.dtype, device=self.device)
                                 for k, s in zip(names, shapes)], -1)
                got = self.own(names[0], cat).split([s[-1] for s in shapes], -1)
                out.update(zip(names, (v.contiguous() for v in got)))
            for k in names:
                if k in full:
                    f = self.shard(k, full[k])
                    out[k] = out[k] + f if k in out else f
        for k in rest:
            out[k] = self.own(k, part.get(k), full.get(k))
        for k in self.names:
            if k not in out:
                shape = list(self.dims[k]) + [self.channels[k]]
                for d, lo, hi in self.owned.get(k) or ():
                    shape[d] = hi - lo
                out[k] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        return {k: out[k] for k in self.names}

    def _view_shape(self, name):
        """The shape of the halo-extended block of a halo image."""
        shape = list(self.dims[name]) + [self.channels[name]]
        for d, lo, hi in self.owned[name]:
            shape[d] = hi - lo
        for d, h, _, _ in self.halos[name]:
            shape[d] += 2 * h
        return tuple(shape)

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
        each element counted on one rank (dot_counts)."""
        total = None
        for k in a:
            if not self.dot_counts[k]:
                continue
            d = torch.dot(a[k].reshape(-1), b[k].reshape(-1))
            total = d if total is None else total + d
        if total is None:
            total = torch.zeros((), dtype=next(iter(a.values())).dtype, device=self.device)
        return total

    def counts_cost(self, gi) -> bool:
        """Whether this rank adds group gi's residuals to a cost: a sharded
        group on every rank that counts its block, an unsharded one on
        rank 0."""
        return self.counted[gi] if self.sharded[gi] else self.rank == 0

    def target(self, gi, part):
        """Where a sharded group's partial sums go on this rank: `part`, or
        a _Discard of it where the rank does not count the group."""
        return part if self.counted[gi] else _Discard(part)


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
    """Refuse a backend that does not suit the plan's device (the backend
    is never swapped), or a mesh that does not span the process group."""
    if not dist.is_initialized():
        raise ValueError("shard_plan_inputs needs torch.distributed: join the ranks first "
                         "(parallel.multihost.initialize, or init_process_group)")
    if mesh.size != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size} ranks, the process group "
                         f"{dist.get_world_size()}: a mesh must span every rank")
    backend = str(dist.get_backend())
    want = "nccl" if plan.device.type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a plan on {plan.device} shards over the {want!r} backend; the "
                         f"process group runs {backend!r} (the backend is never swapped)")


def _coords(mesh, rank):
    """axis name -> this rank's coordinate on the mesh."""
    return dict(zip(mesh.axis_names, (int(c) for c in np.argwhere(mesh.ranks == rank)[0])))


def _neighbour(mesh, coords, axis, step):
    """The global rank `step` places along `axis` from coords (torus)."""
    c = dict(coords)
    c[axis] = (c[axis] + step) % mesh.shape[axis]
    return int(mesh.ranks[tuple(c[a] for a in mesh.axis_names)])


def _owned_blocks(spec, mesh, name_axes):
    """image name -> [(dim, axis, [lo, hi) at each coordinate of the
    axis)] of each unknown, on every mapped dim that its axis's size
    divides, an axis once an image (JAX's place_image); absent:
    replicated."""
    out = {}
    for im in spec.unknowns:
        used = []
        for i, d in enumerate(im.dims):
            ax = name_axes.get(d.name)
            if ax is not None and ax not in [u[1] for u in used] and \
                    d.size % mesh.shape[ax] == 0:
                n = mesh.shape[ax]
                b = d.size // n
                used.append((i, ax, [(r * b, (r + 1) * b) for r in range(n)]))
        if used:
            out[im.name] = used
    return out


def _element_coord(im, dim, flat):
    """The coordinate along `dim` of flat element ids of image im."""
    sizes = [d.size for d in im.dims]
    stride = int(np.prod(sizes[dim + 1:])) if dim + 1 < len(sizes) else 1
    return (flat // stride) % sizes[dim]


def _domain_splits(groups, gin, name_axes, mesh, owned):
    """Each mapped external dim's split into the blocks of its axis's
    coordinates, [n + 1] bounds: a one-axis group's at the owners of a slot
    whose owners never decrease along the dim (the first such slot of the
    first group over it), else equal blocks (a grid group's: the owned
    blocks of the unknowns over the dim).  Also returns, per group, its
    split external axes (ext axis -> dim name), one a mesh axis."""
    splits, axes_of = {}, []
    for gp in groups:
        g = gp.group
        split, seen = {}, set()
        for a, dom in enumerate(g.ext_domains):
            ax = name_axes.get(dom.dim.name)
            if ax is None or ax in seen:
                continue
            seen.add(ax)
            split[a] = dom.dim.name
        axes_of.append(split)
        for a, dname in split.items():
            n = mesh.shape[name_axes[dname]]
            size = g.ext_shape[a]
            if size < n:
                raise ValueError(f"dim {dname} has {size} elements, fewer than the {n} ranks")
            if dname in splits:
                continue
            bounds = None
            if len(g.ext_shape) == 1:
                for s in g.jac_slots:
                    own = next((o for o in owned.get(s.image.name, ())
                                if name_axes.get(s.image.dims[o[0]].name) == name_axes[dname]),
                               None)
                    if own is None or s.dep_cons:
                        continue
                    dim, _, blocks = own
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
    return splits, axes_of


def _reach(view, slot, dim, lo, hi, gin):
    """How far slot's index along image dim `dim` reaches outside [lo, hi)
    over the group view's residual block (unwrapped: a stencil's offset, a
    contraction's index range), or None for an index through a sparse map."""
    c = slot.comps[dim]
    if any(isinstance(base, SparseComp) for base, _ in c.terms):
        return None
    env, _ = view._grid_env(slot.dep_cons, view._sparse_arrays(gin))
    v = env.eval(c)
    return max(0, lo - int(v.min()), int(v.max()) - (hi - 1))


def _halo_plan(comp, spec, local, sharded, owned, gin, coords, mesh, name_axes):
    """Which owned unknowns a step reads as halo-extended blocks, and each
    mapped dim's halo width: the largest reach of any slot of a sharded
    group along it (stencil offsets, contraction index ranges, a blocked
    contraction's whole range), agreed by the ranks.  An image is read
    whole instead (the graph path's all_gather; logged) where a slot reaches
    beyond one neighbour's block or through a sparse map, where a group
    that reads it is unsharded, materializes JᵀJ (block-sparse tables or
    a dense JᵀJ) or reads a materialized computed array, where an Exclude
    guard that reads unknowns reads it, and under linear_solver="direct".
    Returns ({name: ((dim, h, lower, upper), ...)}, {dim name: h}, log)."""
    from ..solver.gn import MATERIALIZED_JTJ

    names = sorted(owned)
    ims = {im.name: im for im in spec.unknowns}
    dyn = set()
    for im in spec.unknowns:
        if im.name in comp._exclude_fns and comp._exclude_fns[im.name][0].uslots:
            dyn.add(im.name)
            dyn.update(s.image.name for s in comp._exclude_fns[im.name][0].uslots)
    keys = [(n, d) for n in names for d, _, _ in owned[n]]
    reach = {k: 0 for k in keys}
    whole = {n: None for n in names}
    for gp, sh in zip(local, sharded):
        g = gp.group
        read = {s.image.name for s in g.jac_slots}
        for n in read & set(names):
            if not sh:
                whole[n] = whole[n] or f"group {gp.name!r} is unsharded"
            elif g.mslots:
                whole[n] = whole[n] or f"group {gp.name!r} reads a computed array"
            elif g.con_block is None and gp.schedule in MATERIALIZED_JTJ:
                whole[n] = whole[n] or f"group {gp.name!r} materializes JᵀJ"
        if not sh:
            continue
        for s in g.jac_slots:
            n = s.image.name
            if n not in owned:
                continue
            for d, _, _ in owned[n]:
                lo, hi = next((lo, hi) for dd, lo, hi in _blocks_at(owned[n], coords) if dd == d)
                r = _reach(g, s, d, lo, hi, gin)
                if r is None:
                    whole[n] = whole[n] or f"group {gp.name!r} reads it through a sparse map"
                else:
                    reach[(n, d)] = max(reach[(n, d)], r)
    for n in names:
        if n in dyn:
            whole[n] = whole[n] or "an Exclude guard reads unknowns"
        if comp.direct_solve:
            whole[n] = whole[n] or "linear_solver='direct'"
    # every rank: the largest reach, and whether any rank reads it whole
    vals = [-reach[k] for k in keys] + [0 if whole[n] is None else -1 for n in names]
    agreed = comm.all_min(vals, comp.device) if vals else []
    reach = {k: -v for k, v in zip(keys, agreed)}
    flags = agreed[len(keys):]
    dim_h = {}
    for n, f in zip(names, flags):
        if f < 0:
            whole[n] = whole[n] or "another rank reads it whole"
            continue
        for d, ax, blocks in owned[n]:
            if reach[(n, d)] > blocks[0][1] - blocks[0][0]:
                whole[n] = f"a slot reaches {reach[(n, d)]} beyond its block along " \
                           f"{ims[n].dims[d].name}, past the neighbour's " \
                           f"{blocks[0][1] - blocks[0][0]}"
    for n in names:
        if whole[n] is None:
            for d, _, _ in owned[n]:
                dn = ims[n].dims[d].name
                dim_h[dn] = max(dim_h.get(dn, 0), reach[(n, d)])
    halos, log = {}, []
    for n in names:
        if whole[n] is not None:
            log.append(f"{n}: read whole by all_gather ({whole[n]})")
            continue
        dims = ims[n].dims
        halos[n] = tuple((d, dim_h[dims[d].name], _neighbour(mesh, coords, ax, -1),
                          _neighbour(mesh, coords, ax, 1)) for d, ax, _ in owned[n])
        log.append(f"{n}: halo " + ", ".join(f"{dims[d].name} {h}" for d, h, _, _ in halos[n]))
    return halos, dim_h, log


def _blocks_at(owned_img, coords):
    """((dim, lo, hi), ...) of an owned image at the given coordinates."""
    return tuple((d, *blocks[coords[ax]]) for d, ax, blocks in owned_img)


def bind_sharded(plan, gin):
    """Bind the plan's global normalized inputs `gin` under its mesh: the
    ranks' residual blocks and local groups, the halo plan, the prepared
    tables of this rank's shard (built from the global inputs, then kept:
    a constant array a slot reads is taken with its halo here, once), the
    solver's ShardCtx, and `plan._inputs` as this rank's view (owned
    blocks of the unknowns, the residual blocks of the arrays and sparse
    maps over a split dim, everything else whole)."""
    comp, spec, mesh = plan.compiled, plan.spec, plan.mesh
    name_axes = plan._dim_axes
    ims = {im.name: im for im in spec.unknowns}
    rank = dist.get_rank()
    coords = _coords(mesh, rank)
    busy = {a for a, n in mesh.shape.items() if n > 1}
    owned_all = _owned_blocks(spec, mesh, name_axes)
    if comp._global_groups is None:
        comp._global_groups = list(comp.groups)
    splits, axes_of = _domain_splits(comp._global_groups, gin, name_axes, mesh, owned_all)
    gblocks, counted = [], []
    for split in axes_of:
        blocks = {}
        for a, dname in split.items():
            b, c = splits[dname], coords[name_axes[dname]]
            blocks[a] = (int(b[c]), int(b[c + 1]))
        gblocks.append(blocks)
        used = {name_axes[d] for d in split.values()}
        counted.append(all(coords[a] == 0 for a in busy - used) if split else rank == 0)
    sharded = [bool(b) for b in gblocks]

    def views(wins=None):
        return [dataclasses.replace(gp, group=gp.group.shard_view(b, windows=wins)) if b
                else gp for gp, b in zip(comp._global_groups, gblocks)]

    local = views()
    owned = {im.name: None for im in spec.unknowns}
    rank_blocks, dot_counts, scatter_ok, windows = {}, {}, set(), {}
    for name, dims in owned_all.items():
        owned[name] = _blocks_at(dims, coords)
        rank_blocks[name] = [_blocks_at(dims, _coords(mesh, r)) for r in range(mesh.size)]
        axes = {ax for _, ax, _ in dims}
        dot_counts[name] = all(coords[a] == 0 for a in busy - axes)
        if len(dims) == 1 and mesh.shape[dims[0][1]] == mesh.size:
            scatter_ok.add(name)
    for im in spec.unknowns:
        dot_counts.setdefault(im.name, rank == 0)
    halos, dim_h, log = _halo_plan(comp, spec, local, sharded, owned_all, gin, coords, mesh,
                                   name_axes)
    if plan.verbosity:
        print(f"[thallo_tpu_torch] rank {rank} sharded reads: {'; '.join(log)}")
    plan._halo_log = log
    plan._halo_widths = dict(dim_h)
    if halos and plan.device.type == "cuda" and plan.steps_per_dispatch > 1 and \
            any(lo != rank or up != rank for hs in halos.values() for _, _, lo, up in hs):
        raise NotImplementedError(
            "steps_per_dispatch > 1 with a halo exchange across ranks: NCCL's "
            "point-to-point send inside a CUDA graph capture hung on an H100 (PERF.md); "
            "run the sharded grid plan with steps_per_dispatch=1")
    wins = {}
    for name, hs in halos.items():
        w = [(0, d.size) for d in ims[name].dims]
        for (d, lo, hi), (_, h, _, _) in zip(owned[name], hs):
            w[d] = (lo - h, hi - lo + 2 * h)
        wins[name] = tuple(w)
    if wins:
        local = views(wins)
    comp.groups = local
    for name, blocks in owned.items():
        if blocks is not None and name not in halos and len(blocks) == 1 and blocks[0][0] == 0:
            _, lo, hi = blocks[0]
            inner = int(np.prod([d.size for d in ims[name].dims[1:]]))
            windows[name] = (lo * inner, hi * inner)
    ctx = ShardCtx(spec.unknowns, owned, sharded, windows, plan.device, plan.dtype, counted,
                   halos, rank_blocks, dot_counts, scatter_ok)
    comp.shard_ctx = ctx
    prep = comp.prepare(gin)
    # the ranks must have taken the same table decisions (the collectives
    # of a step follow them), and an owned image read whole is
    # local-complete when no rank's sharded groups touch it outside that
    # rank's block
    built = [int(c["bsr"] is not None) for c in prep["consts"]]
    if not comm.agree(built, plan.device):
        raise ValueError("the ranks built block-sparse tables for different groups (a rank's "
                         "residual block is too small for its tables); shard fewer ranks")
    flags = []
    names = [n for n in ctx.names if owned[n] is not None and n not in halos]
    for name in names:
        ok = True
        for gp, sh in zip(local, sharded):
            if not sh:
                continue
            g = gp.group
            for s in g.jac_slots:
                if s.image.name != name:
                    continue
                flat = g._slot_flat_indices(s, gin).astype(np.int64)
                for dim, lo, hi in owned[name]:
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
            b, c = splits[first], coords[name_axes[first]]
            view[k] = v[int(b[c]):int(b[c + 1])]
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
    is kept.  Raises ValueError for a backend that does not suit the
    plan's device, and NotImplementedError for a CUDA graph of the step
    (steps_per_dispatch > 1 on the card) around a halo exchange across
    ranks."""
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
    kind and the bytes of the per-rank results (a halo exchange counts as
    one collective_permute of the slabs it receives)."""
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
        gshape = tuple(v.shape) if o is None else ctx.dims[name] + (v.shape[-1],)
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



def global_jacobian(plan, dense=False):
    """plan.jacobian() of a sharded plan, on every rank: the unsharded
    plan's J (its groups over the global inputs, rows in its order) at the
    whole unknowns, gathered first."""
    comp, ctx = plan.compiled, plan.compiled.shard_ctx
    U = ctx.whole_tree(plan._U)
    gin = plan._global_inputs()
    groups = comp.groups
    comp.shard_ctx, comp.groups = None, comp._global_groups
    try:
        prep = comp.prepare(gin)
        masks = comp.masks(gin, U, prep.get("masks_static"), prep.get("exclude_consts"))
        if dense:
            return comp.dense_jacobian(U, gin, prep["consts"], masks)
        return comp.coo_jacobian(U, gin, prep["consts"], masks)
    finally:
        comp.shard_ctx, comp.groups = ctx, groups
