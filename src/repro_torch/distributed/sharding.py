"""Logical-axis sharding rules over ``torch.distributed.DeviceMesh`` and
DTensor, as ``repro/distributed/sharding.py``.

Model code annotates activations with *logical* axis names via
:func:`constrain`; parameters get specs from path-based rules in
:func:`param_specs`.  Resolution is mesh-shape aware: a logical axis maps
to its mesh axes only when the dimension size divides the axis size and
the axis is not already taken by another dim - so the same model code
runs on the 16x16 mesh, the 2x16x16 multi-pod mesh, a small test mesh or
one device (everything resolves to replicated).

A resolved spec is a :class:`P` (the port's ``PartitionSpec``: one entry
a tensor dim, ``None``, a mesh axis name or a tuple of them);
:func:`placements` turns it into DTensor placements, one a mesh dim.  A
dim resolved to ``("pod", "data")`` is ``Shard(dim)`` on both mesh dims,
split in mesh order (pod-major), as XLA splits it.

Where XLA's SPMD partitioner inserts collectives itself, DTensor's
sharding propagation does so op by op.  An op with no DTensor sharding
rule runs through :func:`local_call`: its DTensor arguments are
redistributed so that only the dims it may keep split stay split (all
others ``Replicate``), and it runs on the local shards.

FSDP is intra-pod only ('data'); across pods plain DP over the slow links
(gradients cross pods once per step; see ``distributed/compression.py``).
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import math
import re
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.memory import resolve_device

# logical axis -> ordered mesh-axis candidates (prefix-greedy)
RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "expert": ("model",),
    "heads": ("model",),
    "vocab": ("model",),
    "seq": (),              # sequence unsharded by default
    "seq_sp": ("model",),   # Megatron sequence parallelism (cfg.seq_parallel)
    "kv_seq": (),           # hillclimb: ("data",) when cfg.seq_shard_long
    "none": (),
}

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_active_mesh", default=None)


class P(tuple):
    """A partition spec: one entry a tensor dim (``None``, a mesh axis
    name, or a tuple of names split in order)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def active_mesh():
    return _ACTIVE.get()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Install ``mesh`` (and optional rule overrides) for model
    annotations; the old rules come back on exit."""
    global RULES
    tok = _ACTIVE.set(mesh)
    old = RULES
    if rules:
        RULES = {**RULES, **rules}
    try:
        yield mesh
    finally:
        _ACTIVE.reset(tok)
        RULES = old


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, or of any object with
    ``axis_names`` and ``devices.shape`` (a JAX mesh, a test's stand-in)."""
    if hasattr(mesh, "mesh_dim_names"):
        names, shape = mesh.mesh_dim_names, tuple(mesh.mesh.shape)
    else:
        names, shape = mesh.axis_names, tuple(mesh.devices.shape)
    return dict(zip(names, shape, strict=True))


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def device_type(device=None) -> str:
    """The mesh's device type, by the port's rule
    (:func:`repro_torch.core.memory.resolve_device`): ``device``'s when
    given (an explicit ``"cpu"`` is honoured), else the card's; raises
    when no card is present and none was asked for."""
    return resolve_device(device).type


def make_mesh(shape, axes, *, device=None):
    """A DeviceMesh of ``shape`` over the default process group, its dims
    named ``axes``.  The group's world size must be ``prod(shape)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs a process group of {need} ranks, "
            f"have {have}")
    return init_device_mesh(device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def resolve(mesh, shape, logical: tuple[Optional[str], ...]) -> P:
    """Map logical dim names to a :class:`P` valid for ``shape`` on
    ``mesh``."""
    assert len(logical) == len(shape), (logical, shape)
    used: set[str] = set()
    out = []
    sizes = axis_sizes(mesh)
    for dim, name in zip(shape, logical, strict=True):
        if name is None or name == "none":
            out.append(None)
            continue
        cands = [a for a in RULES.get(name, ()) if a in sizes and a not in used]
        picked: list[str] = []
        prod = 1
        for a in cands:  # greedy prefix while divisibility holds
            if dim % (prod * sizes[a]) == 0:
                picked.append(a)
                prod *= sizes[a]
            else:
                break
        used.update(picked)
        out.append(tuple(picked) if len(picked) > 1 else
                   (picked[0] if picked else None))
    return P(*out)


def placements(mesh, spec) -> tuple:
    """DTensor placements (one a mesh dim) of ``spec``: ``Shard(d)`` on
    every mesh dim that splits tensor dim ``d``, ``Replicate()`` on the
    rest."""
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def constrain(x, *logical: Optional[str]):
    """Redistribute a DTensor to the placements its logical names resolve
    to; the identity without a mesh, on a mesh of one device, or for a
    plain tensor."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh_size(mesh) == 1 or not isinstance(x, DTensor):
        return x
    want = placements(mesh, resolve(mesh, x.shape, logical))
    if tuple(x.placements) == want:
        return x
    return x.contiguous().redistribute(x.device_mesh, want).contiguous()


def replicate(x):
    """``x`` with every mesh dim ``Replicate`` (a DTensor), else ``x``."""
    return keep_split(x, ())


def keep_split(x, dims):
    """A DTensor with only its splits of tensor ``dims`` kept (every other
    mesh dim ``Replicate``); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    ndim = x.dim()
    want = tuple(p if p.is_shard() and p.dim % max(ndim, 1) in
                 {d % max(ndim, 1) for d in dims} else Replicate()
                 for p in x.placements)
    if tuple(x.placements) == want:
        return x
    return x.contiguous().redistribute(x.device_mesh, want).contiguous()


def local_call(fn, *args, keep=(), out_like: int = 0, whole=(), **kwargs):
    """``fn(*args, **kwargs)`` for an op with no DTensor sharding rule.

    Without a DTensor among ``args`` it is the plain call.  Otherwise
    argument ``out_like`` keeps only its splits of the tensor dims
    ``keep`` (every other mesh dim is redistributed to ``Replicate``); the
    arguments whose indices are in ``whole`` (parameters) are made whole;
    every other DTensor argument is split as ``out_like`` is on those
    dims.  ``fn`` runs on the local shards, and each tensor it returns (in
    a tuple, list or dict, or alone) is a DTensor with ``out_like``'s
    placements, so every output runs with it on the dims ``keep``.
    Gradients flow through (``to_local`` / ``from_local``): a whole
    argument gets a ``Partial`` gradient on the mesh dims where the
    output is split, its shards' contributions summed.  A plain tensor
    beside a DTensor is used as it is on every rank."""
    from torch.distributed.tensor import Partial
    dts = [t for t in _tensors(args) if isinstance(t, DTensor)]
    if not dts:
        return fn(*args, **kwargs)
    mesh = dts[0].device_mesh
    like = keep_split(args[out_like], keep)
    if not isinstance(like, DTensor):
        raise TypeError(f"local_call: argument {out_like} is not a DTensor")
    out_pl = tuple(like.placements)

    def align(a):
        if not isinstance(a, DTensor):
            return a
        want = tuple(p if p.is_shard() and p.dim < a.dim() else Replicate()
                     for p in out_pl)
        return a if tuple(a.placements) == want else \
            a.contiguous().redistribute(mesh, want).contiguous()

    args = tuple(like if i == out_like
                 else _tree(replicate, a) if i in whole
                 else _tree(align, a) for i, a in enumerate(args))

    def to_local(a):
        if not isinstance(a, DTensor):
            return a
        grad_pl = [Partial() if p.is_replicate() and o.is_shard() else p
                   for p, o in zip(a.placements, out_pl, strict=True)]
        return a.to_local(grad_placements=grad_pl)

    out = fn(*_tree(to_local, args), **kwargs)
    return _tree(lambda t: DTensor.from_local(t, mesh, out_pl,
                                              run_check=False)
                 if isinstance(t, torch.Tensor) else t, out)


def _tree(fn, x):
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    return fn(x)


def _tensors(x) -> list:
    out = []
    _tree(out.append, x)
    return [t for t in out if isinstance(t, torch.Tensor)]


#: each view :func:`reshape` could not keep split, by ``"reshape <shape>
#: -> <shape>: <placements> -> <placements>"``: how often it gathered
#: instead (the dry run clears it before a cell and reports it)
RESHARDS: collections.Counter = collections.Counter()


def reshape(x, *shape):
    """``x.reshape(*shape)``.  A DTensor whose splits the view cannot keep
    (a split dim cut unevenly) keeps only its batch split, or none, and
    the gather is counted in :data:`RESHARDS`."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        pass
    y = keep_split(x, (0,))
    try:
        out = y.reshape(*shape)
    except RuntimeError:
        y = replicate(x)
        out = y.reshape(*shape)
    RESHARDS[f"reshape {list(x.shape)} -> {list(shape)}: "
             f"{tuple(x.placements)} -> {tuple(y.placements)}"] += 1
    return out


def assign(dst, index, src) -> None:
    """``dst[index] = src`` in place.  A DTensor ``dst`` is written shard
    by shard: ``index`` may pick (an int) or cut (a slice) only dims that
    are whole, and ``src`` is split as ``dst[index]`` is."""
    if not isinstance(dst, DTensor):
        dst[index] = src
        return
    index = index if isinstance(index, tuple) else (index,)
    picked = [d for d, ix in enumerate(index) if isinstance(ix, int)]
    want = []
    for p in dst.placements:
        if not p.is_shard():
            want.append(Replicate())
            continue
        if p.dim < len(index) and index[p.dim] != slice(None):
            raise ValueError(f"assign: index {index} cuts dim {p.dim}, "
                             f"which {p} splits")
        want.append(Shard(p.dim - sum(d < p.dim for d in picked)))
    src = whole_like(src, dst)
    if tuple(src.placements) != tuple(want):
        src = src.redistribute(dst.device_mesh, want)
    dst.to_local()[index] = src.to_local()


def like_batch(t, ref):
    """A plain tensor ``t`` whose dim 0 runs with ``ref``'s (a batch of
    positions, a mask) as a DTensor split on dim 0 as ``ref`` is (whole
    elsewhere); ``t`` itself when ``ref`` is not a DTensor."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    whole = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    want = [p if p.is_shard() and p.dim == 0 else Replicate()
            for p in ref.placements]
    return whole.redistribute(mesh, want)


def whole_like(t, ref):
    """A plain tensor ``t`` as a replicated DTensor on ``ref``'s mesh
    (``t`` itself when ``ref`` is not a DTensor)."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# Parameter specs: path-regex -> logical names per dim (rightmost dims; any
# leading dims - e.g. the stacked layer axis - are replicated).
# ---------------------------------------------------------------------------
PARAM_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    (r"embed/tok$",            ("vocab", "fsdp")),
    (r"embed/codebooks$",      ("none", "vocab", "fsdp")),
    (r"patch_proj$",           ("fsdp", "tp")),
    (r"(wq|wk|wv|w_in)$",      ("fsdp", "tp")),
    (r"(bq|bk|bv)$",           ("tp",)),
    (r"wo$",                   ("tp", "fsdp")),
    (r"(w_gate|w_up)$",        ("fsdp", "tp")),
    (r"w_down$",               ("tp", "fsdp")),
    (r"router$",               ("fsdp", "none")),
    (r"experts/(w_gate|w_up)$", ("expert", "fsdp", "tp")),
    (r"experts/w_down$",       ("expert", "tp", "fsdp")),
    (r"(in_proj|rkvg|w1)$",    ("fsdp", "tp")),
    (r"(out_proj|w2)$",        ("tp", "fsdp")),
    (r"lm_head$",              ("fsdp", "vocab")),
    (r"lm_heads$",             ("none", "fsdp", "vocab")),
    # norms, biases, decays, small states: replicated
    (r".*",                    ()),
]


def _path_str(path) -> str:
    """A leaf's path as ``a/b/c``: the port's nested-dict keys (or
    entries with ``key`` / ``idx``, as JAX's path entries)."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def spec_for_path(mesh, path_str: str, shape) -> P:
    for pat, logical in PARAM_RULES:
        if re.search(pat, path_str):
            names: list = [None] * len(shape)
            if logical:
                k = min(len(logical), len(shape))
                names[len(shape) - k:] = list(logical)[-k:] if k < len(logical) \
                    else list(logical)
            return resolve(mesh, shape, tuple(names))
    return P()


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts (keys sorted), lists and
    tuples, keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, x, path + (i,))
                          for i, x in enumerate(tree))
    return fn(path, tree)


def param_specs(params_shape, mesh):
    """A tree of :class:`P` matching a params (shape) tree."""
    return map_with_path(
        lambda path, leaf: spec_for_path(mesh, _path_str(path), leaf.shape),
        params_shape)


def param_placements(params_shape, mesh):
    """A tree of DTensor placements matching a params (shape) tree."""
    return map_with_path(
        lambda path, leaf: placements(mesh, spec_for_path(
            mesh, _path_str(path), leaf.shape)), params_shape)


def distribute(x, mesh, pl):
    """``x`` as a DTensor of placements ``pl`` on ``mesh``; on a mesh of
    one device, or for a 0-d tensor (a step count every rank holds), the
    plain tensor moved to the mesh's device type."""
    if mesh_size(mesh) == 1 or x.dim() == 0:
        return x.to(mesh.device_type) if x.device.type != "meta" else x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, list(pl))


def shard_params(params, mesh):
    """Each leaf distributed with its resolved placements; at a mesh of
    one device the leaves stay plain tensors on that device, as the
    reference's single-device arrays do."""
    return map_with_path(
        lambda path, leaf: distribute(leaf, mesh, placements(
            mesh, spec_for_path(mesh, _path_str(path), leaf.shape))),
        params)


def at_path(tree, path):
    """The node of ``tree`` at ``path`` (:func:`map_with_path`'s keys)."""
    for k in path:
        tree = getattr(tree, k) if isinstance(k, str) and hasattr(
            tree, "_fields") else tree[k]
    return tree


#: the decode cache's logical dims by leaf name
CACHE_LOGICAL = {
    "k":       (None, "batch", "kv_seq", "heads", None),
    "v":       (None, "batch", "kv_seq", "heads", None),
    "conv":    (None, "batch", None, "tp"),
    "ssm":     (None, "batch", None, "heads", None, None),
    "wkv":     (None, "batch", "heads", None, None),
    "last_tm": (None, "batch", None, None),
    "last_cm": (None, "batch", None, None),
    "pos":     (),
}


def cache_placements(mesh, name: str, shape) -> tuple:
    """A cache leaf's placements by :data:`CACHE_LOGICAL` (whole where the
    name is unknown; dims past the table's whole too)."""
    logical = CACHE_LOGICAL.get(name, (None,) * len(shape))
    logical = tuple(logical[: len(shape)]) + (None,) * (
        len(shape) - len(logical))
    return placements(mesh, resolve(mesh, shape, logical))


def zeros(shape, dtype, like, name: str):
    """Zeros of a cache leaf: plain on ``like``'s device, or - ``like`` a
    DTensor - a DTensor of :func:`cache_placements` on its mesh, each
    device holding only its shard."""
    if not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    mesh = like.device_mesh
    pl = cache_placements(mesh, name, shape)
    local = torch.zeros(local_shape(shape, mesh, pl), dtype=dtype,
                        device=like.to_local().device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def local_shape(shape, mesh, pl) -> list:
    """One device's shard shape of ``shape`` under placements ``pl`` (the
    splits even, as :func:`resolve` makes them)."""
    local = list(shape)
    for p, n in zip(pl, mesh.mesh.shape, strict=True):
        if p.is_shard():
            local[p.dim] //= n
    return local


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def batch_placements(mesh, shape) -> tuple:
    """A batch leaf's placements: dim 0 ``"batch"``, the rest whole."""
    return placements(mesh, resolve(mesh, shape,
                                    ("batch",) + (None,) * (len(shape) - 1)))


def full(x):
    """A DTensor's whole value as a plain tensor; anything else as is."""
    return x.full_tensor() if isinstance(x, DTensor) else x
