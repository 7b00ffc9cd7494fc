"""Meshes of the production and smoke topologies (torch port of
``repro.launch.mesh``), and the arithmetic of a spec on a mesh.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes
(``pod``, ``data``, ``model``) over the ranks of the default process group,
row-major as ``jax.make_mesh`` lays out its devices.  The layout functions
(``train/step``, ``serve/sharding``) read only a mesh's axis names and
sizes, so they run on a mesh of any size built under the ``fake`` process
group, or on an :class:`AbstractMesh`, allocating nothing.

A spec is a plain tuple with one entry a dim, as ``PartitionSpec`` holds
them: ``None`` (replicated), an axis name, or a tuple of names (the dim is
split over their product, the first name major).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes and nothing else (``jax.sharding.
    AbstractMesh``): every layout function takes it, and it needs no
    process group, so a process that already holds one (a run on the card)
    can lay out a production mesh."""

    shape: tuple
    mesh_dim_names: tuple


def make_mesh(shape, axes, device="cuda"):
    """A mesh of ``shape`` named ``axes`` over the world; ``device`` as
    ``kernels.resolve_device`` takes it (the CPU only when asked).  A shape
    whose product is not the world size raises ``ValueError``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name its axes {axes}")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} holds {int(np.prod(shape))} ranks, "
                         f"the world {world}")
    dev = kernels.resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh: 16 x 16 data x model (256 devices), or 2 x 16
    x 16 pod x data x model (512)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device=device)
    return make_mesh((16, 16), ("data", "model"), device=device)


def smoke_shape(n: int, *, pods: int = 1) -> tuple:
    """``(shape, axes)`` of the reference's smoke mesh of ``n`` devices: the
    largest ``data`` up to sqrt of the devices a pod that divides them, the
    rest on ``model``."""
    if pods > 1:
        if n % pods:
            raise ValueError(f"{n} devices do not split into {pods} pods")
        per = n // pods
        d = int(np.floor(np.sqrt(per)))
        while per % d:
            d -= 1
        return (pods, d, per // d), ("pod", "data", "model")
    d = int(np.floor(np.sqrt(n)))
    while n % d:
        d -= 1
    return (d, n // d), ("data", "model")


def make_smoke_mesh(n_devices: int | None = None, *, pods: int = 1, device="cuda"):
    """The smoke mesh (:func:`smoke_shape`) over ``n_devices`` (default:
    the world)."""
    n = n_devices or dist.get_world_size()
    return make_mesh(*smoke_shape(n, pods=pods), device=device)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))


def entry_names(entry) -> tuple:
    """The axis names of one spec entry (none for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_size(entry, mesh) -> int:
    """The number of blocks a spec entry splits its dim into."""
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in entry_names(entry)]))


def padded(spec, ndim: int) -> list:
    """The entries of ``spec`` padded with ``None`` to ``ndim`` dims."""
    return list(spec) + [None] * (ndim - len(spec))


def shard_shape(shape, spec, mesh) -> tuple:
    """The per-device shape of a global ``shape`` laid out by ``spec``."""
    out = list(shape)
    for d, e in enumerate(padded(spec, len(out))[:len(out)]):
        out[d] //= entry_size(e, mesh)
    return tuple(out)


def shard_bytes(tree_and_specs, mesh) -> int:
    """The bytes one device holds of a tree of (``meta``) tensors laid out
    by a spec tree: ``(tree, specs)`` as the abstract layouts return them."""
    from repro_torch.tree_util import tree_flatten, tree_flatten_up_to

    tree, specs = tree_and_specs
    leaves, treedef = tree_flatten(tree)
    return sum(int(np.prod(shard_shape(t.shape, s, mesh))) * t.element_size()
               for t, s in zip(leaves, tree_flatten_up_to(treedef, specs)))


def block_of(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a global tensor laid out by ``spec`` on ``mesh``:
    on each split dim, block ``i`` of the entry's product, ``i`` the rank's
    index over the entry's axes, the first axis major (``P(("pod",
    "data"))`` puts rank (p, d) at block ``p * n_data + d``)."""
    sizes, coord = axis_sizes(mesh), dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for d, e in enumerate(padded(spec, t.ndim)[:t.ndim]):
        names = entry_names(e)
        if not names:
            continue
        idx = 0
        for a in names:
            idx = idx * sizes[a] + coord[a]
        n = entry_size(e, mesh)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split into {n} blocks")
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t


def axis_group(mesh, axes):
    """The process group over ``axes`` of ``mesh`` that holds this rank,
    its ranks in the order of the reference's ``_dp_index`` (the first axis
    major): the world itself when the axes span it, else one
    ``dist.new_group`` a slice of the mesh's rank grid, made in the same
    order on every rank (``new_group`` is collective).  Cached on the mesh,
    so a mesh makes each group once."""
    axes = tuple(axes)
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if axes in cache:
        return cache[axes]
    names, grid = tuple(mesh.mesh_dim_names), mesh.mesh
    if int(np.prod([axis_sizes(mesh)[a] for a in axes])) == dist.get_world_size():
        cache[axes] = dist.group.WORLD
        return cache[axes]
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(grid.ndim) if i not in keep]
    slices = grid.permute(*rest, *keep).reshape(-1, int(np.prod([grid.shape[i] for i in keep])))
    me, mine = dist.get_rank(), None
    for ranks in slices.tolist():
        g = dist.new_group(ranks=ranks)
        if me in ranks:
            mine = g
    cache[axes] = mine
    return mine
