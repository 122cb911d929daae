"""Sharding rules of the port: ``repro.distributed.sharding`` on a
``launch.mesh.Mesh``, and what it takes to run them on local shards.

The rules are the JAX module's, leaf for leaf: Megatron TP (column-parallel
up projections, row-parallel down projections), vocab-parallel embedding
and head, experts over ``data`` (EP) and TP over their ``d_ff``, ZeRO's
extra optimizer-state axis, batches over (pod, data), and the decode
caches' two layouts. A spec is a tuple with one entry per leading dim: an
axis name, a tuple of axis names, or None; shorter than the leaf's rank
where the JAX ``PartitionSpec`` is (``()`` replicates). The JAX module's
global ``_ACTIVE_CFG`` is the explicit ``cfg`` argument here.

The rules match the JAX-layout path of a leaf ("units/u0/attn/wq"), whose
stacked layers carry a leading unit axis. ``leaf_spec`` gives a port leaf
(``blocks.<i>.<group>.<name>``) the JAX rule of its JAX leaf, whose shape
it rebuilds, the leading unit axis then dropped.

To run a spec the port keeps plain local tensors (no DTensor: the kernel
ops are ctypes and Triton launches on raw pointers, which no DTensor
dispatch rule reaches): ``shard`` cuts this rank's slice of a whole leaf,
``gather`` rebuilds the whole leaf from the ranks' slices. ``ModelShard``
is this rank's share of a model on a (data, model) or (pod, data, model)
mesh: the local config the layers run (heads, kv heads and ``d_ff`` over
``model``; RWKV6's wkv heads and channel-mix width), the vocab rows and
experts it holds, the batch rows (over pod and data, or for serving
replicated over a DP axis that does not divide them: the JAX
``_batch_axes`` rule), ZeRO's slices of the optimizer state, and the
gradient reductions a step needs.

ZeRO (``zero_spec``): the fp32 master copy and moments of a leaf take one
more axis, the DP axes its spec leaves free, on the first dim they divide;
each rank updates its slice and the new bf16 values are all-gathered over
that axis. Where the JAX rule puts that axis on the stacked unit axis of a
layer leaf (a leaf whose other dims it does not divide, or which is
sharded on them), the port's layer leaf takes it on the first dim of its
own that it divides, after that dim's own axes (``zero_placement``): the
same bytes a rank, each layer sliced alike (ROADMAP C17). The checkpoint
layout of an optimizer state (``train_tree_spec``) is that placement.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import collectives as C

DP_AXES = ("pod", "data")     # batch / expert / ZeRO axes
TP_AXIS = "model"

# (regex on path, candidate trailing-dim specs -- first fully-valid wins)
_PARAM_RULES = [
    (r"embed$", [("model", None)]),               # vocab-parallel
    (r"head$", [(None, "model")]),
    (r"(wq|wk|wv)$", [(None, "model")]),          # column-parallel
    (r"(bq|bk|bv)$", [("model",)]),
    (r"wo$", [("model", None)]),                  # row-parallel
    (r"moe/router$", [(None, None)]),
    # EP x TP; when n_experts doesn't divide the data axis (grok: 8 experts
    # on 16-wide data) fall back to sharding the d_model dim over (pod,)data
    (r"moe/w_(up|gate)$", [("data", None, "model"),
                           (None, ("pod", "data"), "model"),
                           (None, "data", "model"),
                           (None, None, "model")]),
    (r"moe/w_down$", [("data", "model", None),
                      (None, "model", ("pod", "data")),
                      (None, "model", "data"),
                      (None, "model", None)]),
    (r"mlp/w_(up|gate)$", [(None, "model")]),
    (r"mlp/w_down$", [("model", None)]),
    (r"(wr|wg)$", [(None, "model")]),             # rwkv head-parallel
    (r"tmix/wo$", [("model", None)]),
    (r"cmix/w_up$", [(None, "model")]),
    (r"cmix/w_down$", [("model", None)]),
    (r"(w_gate|w_in)$", [(None, "model")]),       # rglru channel-parallel
    (r"(w_a|w_x)$", [(None, "model")]),
    (r"rec/w_out$", [("model", None)]),
    (r"conv_w$", [(None, "model")]),
    (r"conv_b$", [("model",)]),
    (r"lam$", [("model",)]),
]

SMALL_EXPERT_BYTES = 1 << 30    # <1 GiB: TP-only sharding is plenty


def _path_str(path) -> str:
    return path if isinstance(path, str) else "/".join(str(k) for k in path)


def _axes(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def _entry(axes):
    """A spec entry of a tuple of axes, as a JAX ``PartitionSpec`` holds
    it: None for none, the name alone for one."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _axis_ok(mesh, axis, dim: int) -> bool:
    if axis is None:
        return True
    size = int(np.prod([mesh.shape[a] for a in _axes(axis)]))
    return dim % size == 0 and dim >= size


def _filter_axes(mesh, axis):
    """Drop mesh axes that don't exist (e.g. 'pod' on the single-pod mesh)."""
    if axis is None:
        return None
    axes = tuple(a for a in _axes(axis) if a in mesh.shape)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def param_spec(mesh, path, shape, cfg: Optional[ModelConfig] = None) -> tuple:
    """The spec of one parameter leaf at its JAX `path` of JAX `shape`;
    `cfg` decides whether k/v projections shard or replicate under TP."""
    s = _path_str(path)
    shape = tuple(shape)
    # GQA: when n_kv_heads doesn't divide the TP axis, sharding wk/wv cuts
    # across head boundaries -- replicate the (small) kv projections
    if cfg is not None and re.search(r"attn/(wk|wv|bk|bv)$", s):
        tp = mesh.shape.get(TP_AXIS, 1)
        if cfg.n_kv_heads and cfg.n_kv_heads % tp != 0:
            return ()
    # small MoE expert tensors (granite: 40 x 1536 x 512) stay TP-only
    if re.search(r"moe/w_(up|down|gate)$", s):
        if int(np.prod(shape)) * 2 < SMALL_EXPERT_BYTES:
            tp_dim = len(shape) - 2 if s.endswith("w_down") else len(shape) - 1
            spec = [None] * len(shape)
            if _axis_ok(mesh, TP_AXIS, shape[tp_dim]):
                spec[tp_dim] = TP_AXIS
            if _axis_ok(mesh, "data", shape[-3]) and shape[-3] > 1:
                spec[-3] = "data"       # E over data when it divides
            return tuple(spec)
    for pat, candidates in _PARAM_RULES:
        if not re.search(pat, s):
            continue
        for trailing in candidates:
            nlead = len(shape) - len(trailing)
            if nlead < 0:
                continue
            spec = [None] * nlead + [_filter_axes(mesh, a) for a in trailing]
            if all(_axis_ok(mesh, a, shape[i]) for i, a in enumerate(spec)):
                return tuple(spec)
        # last resort: the first candidate with invalid axes dropped
        trailing = candidates[0]
        nlead = len(shape) - len(trailing)
        spec = [None] * max(nlead, 0) + [_filter_axes(mesh, a)
                                         for a in trailing][:len(shape)]
        return tuple(a if _axis_ok(mesh, a, shape[i]) else None for i, a in enumerate(spec))
    return ()     # replicate (norms, small vectors)


def zero_spec(mesh, path, shape, cfg: Optional[ModelConfig] = None) -> tuple:
    """ZeRO: the parameter's spec with one replicated dim of the optimizer
    state further sharded over the (pod,)data axes."""
    shape = tuple(shape)
    base = param_spec(mesh, path, shape, cfg)
    spec = list(base) + [None] * (len(shape) - len(base))
    used = {ax for a in spec for ax in _axes(a) if ax}
    free = tuple(a for a in DP_AXES if a in mesh.shape and a not in used)
    if free:
        for i, a in enumerate(spec):
            if a is None and _axis_ok(mesh, free, shape[i]):
                spec[i] = free if len(free) > 1 else free[0]
                break
        else:
            for i, a in enumerate(spec):
                if a is None and _axis_ok(mesh, free[0], shape[i]):
                    spec[i] = free[0]
                    break
    return tuple(spec)


def batch_spec(mesh, batch: int) -> tuple:
    """Shard batch over (pod, data) when divisible; fall back gracefully."""
    axes = [a for a in DP_AXES if a in mesh.shape]
    full = int(np.prod([mesh.shape[a] for a in axes]))
    if batch % full == 0:
        return (_entry(axes),)
    if "data" in mesh.shape and batch % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def _batch_axes(mesh, batch: int):
    """Mesh axes (tuple) to shard a batch dim over, or None."""
    axes = tuple(a for a in DP_AXES if a in mesh.shape)
    full = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    if axes and batch % full == 0 and batch >= full:
        return axes
    if "data" in mesh.shape and batch % mesh.shape["data"] == 0 \
            and batch >= mesh.shape["data"]:
        return ("data",)
    return None


def data_shardings(mesh, shapes: dict) -> dict:
    """Specs of the input arrays (tokens/targets/mask/frontend) by their
    shapes: the leading batch dim over the DP axes."""
    return {name: tuple([_entry(_batch_axes(mesh, shape[0]))] + [None] * (len(shape) - 1))
            for name, shape in shapes.items()}


def cache_spec(mesh, path, shape, batch: int, kv_mode: str = "channel") -> tuple:
    """KV caches / recurrent state: batch over DP axes + one TP dim.

    kv_mode="channel" (Megatron's layout): the fused H*dh channel dim
    shards over model. kv_mode="sequence" (split-KV): the time dim shards
    over model, each shard's softmax partials combined by a (B, H)
    all-reduce."""
    s = _path_str(path)
    shape = tuple(shape)
    if s.endswith("pos") or s.endswith("enc_out"):
        ba = _batch_axes(mesh, shape[0]) if shape else None
        return tuple([_entry(ba)] + [None] * (len(shape) - 1)) if shape else ()
    spec = [None] * len(shape)
    n = len(shape)
    is_kv = s.endswith("/k") or s.endswith("/v") or s.endswith("xk") or s.endswith("xv")
    if s.endswith("state"):
        tp_try = [n - 3, n - 2]           # rwkv state (.., H, N, N)
    elif is_kv and kv_mode == "sequence" and n >= 3:
        tp_try = [n - 2]                  # time axis of (.., T, H*dh)
    else:
        tp_try = [n - 1]                  # fused kv channels / (.., d)
    for i, d in enumerate(shape):
        if d == batch:
            spec[i] = _entry(_batch_axes(mesh, batch))
            for j in tp_try:
                if j > i and _axis_ok(mesh, TP_AXIS, shape[j]) and shape[j] > 1:
                    spec[j] = TP_AXIS
                    break
            break
    return tuple(spec)


def cache_shardings(mesh, leaves: dict, batch: int, kv_mode: str = "channel",
                    cfg: Optional[ModelConfig] = None) -> dict:
    """Specs of cache leaves {path: shape}. kv_mode "auto" is the measured
    policy: channel sharding where kv heads divide the model axis, else
    sequence sharding."""
    if kv_mode == "auto":
        tp = mesh.shape.get(TP_AXIS, 1)
        kvh = cfg.n_kv_heads if cfg is not None else 0
        kv_mode = "channel" if (kvh and kvh % tp == 0) else "sequence"
    return {p: cache_spec(mesh, p, shape, batch, kv_mode) for p, shape in leaves.items()}


# ---------------------------------------------------------------------------
# port leaves and the JAX layout
# ---------------------------------------------------------------------------

def jax_leaf(cfg: ModelConfig, name: str, shape) -> tuple:
    """(JAX path, JAX shape, stacked) of the port leaf `name` of `shape`:
    a layer of a repeated unit (or an encoder layer) gains the leading unit
    axis of the JAX tree."""
    from ..models.bridge import _layer_prefixes
    from ..models.lm import unit_structure
    for (place, sub), prefix, r in _layer_prefixes(cfg):
        if name.startswith(prefix + "."):
            rest = name[len(prefix) + 1:].replace(".", "/")
            if r is None:
                return f"{place}/{sub}/{rest}", tuple(shape), False
            n = cfg.n_encoder_layers if place == "enc" else unit_structure(cfg)[1]
            return f"{place}/{sub}/{rest}", (n,) + tuple(shape), True
    return name.replace(".", "/"), tuple(shape), False


def leaf_spec(mesh, cfg: ModelConfig, name: str, shape) -> tuple:
    """The spec of the port leaf `name` (its own, unstacked `shape`): the
    JAX rule of its JAX leaf, the leading unit axis dropped."""
    path, jshape, stacked = jax_leaf(cfg, name, shape)
    spec = param_spec(mesh, path, jshape, cfg)
    return spec[1:] if stacked and spec else spec


def _stacked(path: str) -> bool:
    """Whether a JAX parameter path is a layer of a stacked unit (or an
    encoder layer), whose leading axis is the unit axis."""
    return path.startswith(("units/", "enc/layers/"))


def zero_placement(mesh, cfg: ModelConfig, path, shape):
    """(dim, axes) of ZeRO's extra axes on the leaf at JAX `path` of JAX
    `shape`, the dim counted in the port's own leaf (a stacked layer leaf
    without its unit axis); None where ``zero_spec`` adds no axis of more
    than one rank. An axis the JAX rule puts on the unit axis goes on the
    first dim of the layer leaf it divides: a dim with no axis first, else
    one whose own axes and it together divide it (see the module's note)."""
    path, shape = _path_str(path), tuple(shape)
    p = _spec_entries(param_spec(mesh, path, shape, cfg), len(shape))
    z = _spec_entries(zero_spec(mesh, path, shape, cfg), len(shape))
    dims = [i for i, (a, b) in enumerate(zip(p, z)) if a != b]
    if not dims:
        return None
    dim = dims[0]
    axes = tuple(x for x in _axes(z[dim]) if x not in _axes(p[dim] or ()))
    if mesh.axis_size(axes) == 1:
        return None
    lead = 1 if _stacked(path) else 0
    if dim >= lead:
        return dim - lead, axes
    own, spec = shape[1:], p[1:]
    for j in [j for j, a in enumerate(spec) if a is None] + \
            [j for j, a in enumerate(spec) if a is not None]:
        if _axis_ok(mesh, tuple(_axes(spec[j] or ())) + axes, own[j]):
            return j, axes
    return None


def _with_zero(spec: tuple, ndim: int, placed) -> tuple:
    """`spec` with ZeRO's axes after the own axes of their dim."""
    if placed is None:
        return tuple(spec)
    dim, axes = placed
    entries = _spec_entries(spec, ndim)
    entries[dim] = _entry(tuple(_axes(entries[dim] or ())) + axes)
    return tuple(entries)


def train_tree_spec(mesh, cfg: ModelConfig, key: str, shape) -> tuple:
    """The spec of a checkpoint leaf of a TrainState in the JAX layout
    (``.params/...``, ``.opt/.master/...``, ``.opt/.m/...``,
    ``.opt/.v/...``; ``.opt/.step`` replicated): the parameter's spec, and
    for the optimizer state the parameter's spec with ZeRO's axes as the
    port places them (``zero_placement``)."""
    if key.startswith(".params/"):
        return param_spec(mesh, key[len(".params/"):], shape, cfg)
    for prefix in (".opt/.master/", ".opt/.m/", ".opt/.v/"):
        if key.startswith(prefix):
            path = key[len(prefix):]
            spec = param_spec(mesh, path, shape, cfg)
            placed = zero_placement(mesh, cfg, path, shape)
            if placed is not None and _stacked(path):
                placed = (placed[0] + 1, placed[1])
            return _with_zero(spec, len(shape), placed)
    return ()


def _spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over."""
    return tuple(x for a in spec if a for x in _axes(a))


def _spec_entries(spec, ndim: int):
    return list(spec) + [None] * (ndim - len(spec))


def shard(t, spec, mesh):
    """This rank's slice of the whole leaf `t` (a tensor or numpy array)
    under `spec`: along each sharded dim, the part of its axes' size at
    this rank's index (the first axis of a tuple the major one). A view."""
    idx = []
    for d, a in zip(t.shape, _spec_entries(spec, t.ndim)):
        if a is None:
            idx.append(slice(None))
            continue
        n = d // mesh.axis_size(a)
        i = mesh.index(a)
        idx.append(slice(i * n, (i + 1) * n))
    return t[tuple(idx)]


def gather(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from the ranks' slices `t` under `spec` (every rank of
    the axes takes part). A tuple of axes gathers its minor axis first."""
    for dim, a in enumerate(_spec_entries(spec, t.ndim)):
        if a is None:
            continue
        for ax in reversed(_axes(a)):
            t = C.all_gather(t.contiguous(), mesh.group(ax), dim=dim)
    return t


# ---------------------------------------------------------------------------
# a model on local shards
# ---------------------------------------------------------------------------

#: the most elements ``ModelShard.sync_grads`` all-reduces in one call
SYNC_BUCKET = 1 << 26

_NO_TP = (("block_pattern", "the channel-parallel RG-LRU (rec/w_out, conv_*, lam)"),
          ("cross_attention", "the encoder-decoder's cross-attention"),
          ("cross_attn_layers", "the vision cross layers"))


#: RWKV6 leaves replicated over model whose gradient a model rank holds a
#: part of: those its time mix reads at its channels, the decay LoRA's
#: first factor, and the shift mixes
_RWKV_PARTIAL = ("tmix.mu", "tmix.w0", "tmix.w_lora_a", "tmix.w_lora_b", "tmix.u", "tmix.ln_x",
                 "cmix.mu")


@dataclasses.dataclass
class ModelShard:
    """This rank's share of a model of `cfg` on `mesh` (a (data, model)
    or a (pod, data, model) mesh): `local` is the config its
    layers run (``n_heads``, ``n_kv_heads`` unless replicated, ``d_ff``
    over model), `specs` each leaf's spec and `shapes` its whole shape,
    `vocab` the padded-vocab rows [lo, hi) it holds, `kv_heads` (first,
    count) of the replicated kv heads its q heads read (None where the kv
    projections shard), `experts` (first, end) of the experts it runs over
    the data axis, `model_partial` the leaves replicated over model whose
    gradients each rank holds a part of (the qk-norm scales: each rank's
    act on its own heads), `zero` each leaf's ZeRO placement (dim, axes) in
    its local shard, where it has one, `rwkv_heads` (first, count) of the
    wkv heads an RWKV6 rank's time mix runs (None off a model axis), and
    `rows` the axes the rows at hand split over where ``split_rows`` set
    them to fewer than every DP axis (None: every one)."""
    mesh: object
    cfg: ModelConfig
    local: ModelConfig
    specs: dict
    shapes: dict
    vocab: tuple
    kv_heads: Optional[tuple]
    experts: tuple
    model_partial: frozenset
    zero: dict = dataclasses.field(default_factory=dict)
    rwkv_heads: Optional[tuple] = None
    rows: Optional[tuple] = None

    @property
    def model_group(self):
        return self.mesh.group(TP_AXIS)

    @property
    def data_group(self):
        return self.mesh.group("data")

    @property
    def pod_group(self):
        return self.mesh.group("pod")

    @property
    def dp_axes(self) -> tuple:
        """The DP axes of the mesh: (pod, data), those it has."""
        return tuple(a for a in DP_AXES if a in self.mesh.shape)

    @property
    def batch_axes(self) -> tuple:
        """The axes the rows at hand split over: every DP axis, unless
        ``split_rows`` set fewer for a serving batch."""
        return self.dp_axes if self.rows is None else self.rows

    @property
    def rwkv_channels(self) -> Optional[tuple]:
        """[c0, c1) of the channels of the rank's wkv heads (None off a model
        axis: all of them)."""
        if self.rwkv_heads is None:
            return None
        first, n = self.rwkv_heads
        N = self.cfg.rwkv_head_dim
        return first * N, (first + n) * N

    def split_rows(self, batch: int, train: bool = False) -> tuple:
        """The axes a batch of `batch` rows splits over, by the JAX
        ``_batch_axes`` rule: every DP axis where their size divides it;
        ``("data",)`` alone where only data's does, the rows then replicated
        over pod; none where neither does, every rank running every row.
        Sets ``rows`` (``batch_axes`` gives them until the next call). A
        train step (`train`) takes only the first: its gradients and loss
        sum over every DP axis, and a batch that does not split raises
        ValueError."""
        axes = _batch_axes(self.mesh, batch) or ()
        if train and axes != self.dp_axes:
            raise ValueError(
                f"a train batch of {batch} rows does not split over "
                f"{'x'.join(self.dp_axes)} = {self.mesh.axis_size(self.dp_axes)}: the JAX "
                "_batch_axes rule replicates its rows over the axes that do not divide it, "
                "which the port runs for prefill and decode only (ROADMAP A12b)")
        self.rows = None if axes == self.dp_axes else axes
        return axes

    @property
    def data_size(self) -> int:
        """The ranks a batch's rows split over (pod times data)."""
        return self.mesh.axis_size(self.batch_axes)

    @property
    def tp(self) -> bool:
        return self.mesh.shape.get(TP_AXIS, 1) > 1

    @property
    def cache_cfg(self) -> ModelConfig:
        """The config of this rank's decode cache: the local one, with the
        replicated kv heads its q heads read where the kv projections
        replicate (``kv_heads``)."""
        if self.kv_heads is None:
            return self.local
        return dataclasses.replace(self.local, n_kv_heads=self.kv_heads[1])

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """This rank's decode cache of `batch` rows: ``init_cache`` of
        ``cache_cfg``, an RWKV6 state of the rank's heads."""
        from ..models.lm import init_cache
        return init_cache(self.cache_cfg, batch, max_len, device,
                          self.rwkv_heads[1] if self.rwkv_heads else None)

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the batch axes (data, then pod)."""
        for axis in reversed(self.batch_axes):
            t = C.all_reduce(t, self.mesh.group(axis))
        return t

    def local_rows(self, a, microbatches: int = 1, train: bool = False):
        """This rank's rows of a global batch array: the batch split into
        `microbatches` first, then each microbatch's rows over the axes
        ``split_rows`` gives it (over (pod, data), pod the major axis, the
        JAX step's ``_shard_microbatch``, for a train step), flattened
        back."""
        if a is None:
            return a
        mb = a.shape[0] // microbatches
        self.split_rows(mb, train)
        D = self.data_size
        if D == 1:
            return a
        r = self.mesh.index(self.batch_axes)
        part = a.reshape(microbatches, mb, *a.shape[1:])[:, r * mb // D:(r + 1) * mb // D]
        return part.reshape(-1, *a.shape[1:])

    def zero_slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO slice of the local leaf `name` (a view; `t`
        itself where the leaf has no ZeRO axis)."""
        placed = self.zero.get(name)
        if placed is None:
            return t
        spec = [None] * t.dim()
        spec[placed[0]] = _entry(placed[1])
        return shard(t, tuple(spec), self.mesh)

    def zero_gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The local leaf `name` from the ranks' ZeRO slices `t` (an
        all-gather over its ZeRO axes)."""
        placed = self.zero.get(name)
        if placed is None:
            return t
        spec = [None] * t.dim()
        spec[placed[0]] = _entry(placed[1])
        return gather(t, tuple(spec), self.mesh)

    def sync_grads(self, grads: dict) -> dict:
        """Gradients of the whole step from this rank's: fp32, summed over
        pod and over data for every leaf not sharded over that axis, and
        over model for the `model_partial` leaves; in buckets of at most
        SYNC_BUCKET elements."""
        out = {n: g.float() for n, g in grads.items()}
        for axis, names in [(a, [n for n in out if a not in _spec_axes(self.specs[n])])
                            for a in reversed(self.batch_axes)] + \
                [(TP_AXIS, [n for n in out if n in self.model_partial])]:
            group = self.mesh.group(axis)
            if group is None:
                continue
            i = 0
            while i < len(names):
                chunk, size = [], 0
                while i < len(names) and (not chunk or size + out[names[i]].numel() <= SYNC_BUCKET):
                    chunk.append(names[i])
                    size += out[names[i]].numel()
                    i += 1
                flat = C.all_reduce(torch.cat([out[n].reshape(-1) for n in chunk]), group)
                for n, part in zip(chunk, flat.split([out[n].numel() for n in chunk])):
                    out[n] = part.view_as(out[n])
        return out

    def global_sq(self, sq: dict) -> torch.Tensor:
        """The squared norm of the whole step's gradients from this rank's
        per-leaf squared norms (after ``sync_grads``): each leaf over its
        replicas once, summed over the mesh."""
        total = sum(s / (self.mesh.size // self.mesh.axis_size(_spec_axes(self.specs[n])))
                    for n, s in sq.items())
        for axis in self.mesh.axis_names:
            total = C.all_reduce(total, self.mesh.group(axis))
        return total

    def gather_state(self, tensors: dict, zero: bool = False) -> dict:
        """Whole leaves on the host from this rank's slices, keyed as
        `tensors`, which are ZeRO's slices with `zero` (the optimizer
        state); every rank of the mesh takes part."""
        return {n: gather(t.detach(), _with_zero(self.specs[n], t.dim(), self.zero.get(n))
                          if zero else self.specs[n], self.mesh).cpu()
                for n, t in tensors.items()}


def check_executable(cfg: ModelConfig, mesh) -> None:
    """Raise where the port cannot run `cfg` on local shards of `mesh`:
    NotImplementedError naming A12b for TP of Griffin and the
    cross-attending models, ValueError naming the dim for heads, d_ff (for
    RWKV6 its wkv heads and channel-mix width) or a padded vocab that the
    model axis does not divide. A pod axis is a data
    axis here (``pipeline_apply`` runs pipeline stages over it, from its
    own caller)."""
    from ..models.lm import padded_vocab
    m = mesh.shape.get(TP_AXIS, 1)
    if m == 1:
        return
    for field, what in _NO_TP:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{cfg.name}: tensor parallelism of {what} ({field}) is ROADMAP A12b; "
                "run it data-parallel (--model 1)")
    if cfg.attention_free:
        dims = (("rwkv heads d_model // rwkv_head_dim", cfg.d_model // cfg.rwkv_head_dim),
                ("channel-mix width int(3.5 * d_model)", int(3.5 * cfg.d_model)))
    else:
        dims = (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff))
    for field, n in dims + (("padded vocab", padded_vocab(cfg)),):
        if n % m:
            raise ValueError(f"{cfg.name}: {field} = {n} does not divide over model = {m}: "
                             "local shards would split it mid-way")
    hkv = cfg.n_kv_heads
    if hkv % m:
        H_loc, G = cfg.n_heads // m, cfg.n_heads // hkv
        if H_loc % G and G % H_loc:
            raise ValueError(f"{cfg.name}: n_heads / model = {H_loc} local q heads do not "
                             f"fall in whole groups of G = {G} over the replicated kv heads")


def plan(cfg: ModelConfig, mesh) -> ModelShard:
    """This rank's ``ModelShard`` of `cfg` on `mesh`; raises as
    ``check_executable`` does, and NotImplementedError for a rule that puts
    a dim the layers do not split over data (grok's d_model at a data
    axis its experts do not divide)."""
    from ..models.lm import LM, padded_vocab
    check_executable(cfg, mesh)
    m, r = mesh.shape.get(TP_AXIS, 1), mesh.index(TP_AXIS)
    meta = LM(cfg, None, "meta")
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    specs = {n: leaf_spec(mesh, cfg, n, s) for n, s in shapes.items()}
    for n, spec in specs.items():
        for dim, a in enumerate(spec):
            if a is not None and a != TP_AXIS and not (".moe.w_" in n and dim == 0):
                raise NotImplementedError(f"{cfg.name}: {n} is sharded {spec}: the port runs "
                                          "experts over data on their expert axis only; "
                                          "d_model over data is ROADMAP A12b")
    hkv, kv_heads = cfg.n_kv_heads, None
    if m > 1 and hkv and hkv % m:
        H_loc, G = cfg.n_heads // m, cfg.n_heads // hkv
        first = r * H_loc // G
        kv_heads = (first, max(H_loc // G, 1))
    local = dataclasses.replace(
        cfg, n_heads=cfg.n_heads // m,
        n_kv_heads=hkv if kv_heads or not hkv else hkv // m,
        # RWKV6's channel mix is int(3.5 d) wide whatever d_ff says
        d_ff=cfg.d_ff if cfg.attention_free else cfg.d_ff // m)
    vpad = padded_vocab(cfg)
    vocab = (r * vpad // m, (r + 1) * vpad // m) if specs["embed"] else (0, vpad)
    E, D = cfg.n_experts, mesh.shape.get("data", 1)
    e_pad = -(-E // D) * D if E else 0          # the JAX _moe_pad_experts
    i = mesh.index("data")
    experts = (min(i * e_pad // D, E), min((i + 1) * e_pad // D, E))
    # the qk-norm scales act on local heads: each rank's gradient is its
    # heads' part (replicated kv heads are whole on every rank: lm.py);
    # RWKV6's replicated time-mix leaves act on the rank's channels, and
    # both mixes' shift mixes sit after f, ahead of its column-parallel
    # products
    partial = {n for n in shapes if m > 1 and (
        n.endswith("attn.q_norm") or (n.endswith("attn.k_norm") and not kv_heads)
        or n.endswith(_RWKV_PARTIAL))}
    rwkv_heads = None
    if m > 1 and cfg.attention_free:
        H = cfg.d_model // cfg.rwkv_head_dim
        rwkv_heads = (r * H // m, H // m)
    zero = {}
    for n, s in shapes.items():
        path, jshape, _ = jax_leaf(cfg, n, s)
        placed = zero_placement(mesh, cfg, path, jshape)
        if placed is not None:
            zero[n] = placed
    return ModelShard(mesh, cfg, local, specs, shapes, vocab, kv_heads, experts,
                      frozenset(partial), zero, rwkv_heads)


def init_sharded(cfg: ModelConfig, mesh, seed: int = 0, device=None):
    """The model of ``models.init_params(cfg, seed, device)`` on local
    shards: every leaf drawn whole from the same seeded generator, in the
    same order, and cut to this rank's slice before the next is drawn, so
    each rank's shard equals the single-rank model's slice and no rank
    holds the whole model. Returns the ``LM`` with ``par`` set."""
    from ..device import resolve_device
    from ..models import layers as L
    from ..models.lm import LM
    par = plan(cfg, mesh)
    dev = resolve_device(device)
    drawn = []
    meta = LM(cfg, L.Draws(None, lambda p: drawn.append(p) or p), "meta")
    names = {id(p): n for n, p in meta.named_parameters()}
    order = iter([names[id(p)] for p in drawn])
    model = LM(cfg, L.Draws(torch.Generator(dev).manual_seed(seed), lambda p: L._param(
        shard(p.data, par.specs[next(order)], mesh).clone())), dev)
    return attach(model, par)


def attach(model, par: ModelShard):
    """Set `model` (built whole, or by ``init_sharded``) to run on `par`'s
    shards: each leaf cut to its slice where it is whole, the layers'
    config the local one. Returns the model."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            if tuple(p.shape) == par.shapes[n] and _spec_axes(par.specs[n]):
                p.data = shard(p.data, par.specs[n], par.mesh).clone()
    model.cfg = par.local
    model.par = par
    for blk in model.blocks:
        blk.par = par
    return model


__all__ = ["DP_AXES", "TP_AXIS", "SMALL_EXPERT_BYTES", "param_spec", "zero_spec", "batch_spec",
           "data_shardings", "cache_spec", "cache_shardings", "jax_leaf", "leaf_spec",
           "train_tree_spec", "zero_placement", "shard", "gather", "ModelShard", "check_executable",
           "plan", "init_sharded", "attach"]
