"""Sharding rules and the parallel context of a model (counterpart of
``climb_tpu/parallel/sharding.py``).

``param_spec`` applies the JAX package's rules to the port's parameter
names: which dim of each tensor splits over which mesh axis.

- q/k/v/fc1 and an adapter's ``down`` split their output dim over 'model',
  attn_out/fc2 and an adapter's ``up`` their input dim; the biases of
  column-split layers split with their outputs.
- FSDP (``fsdp_size > 1``) splits the largest still-unsplit dim divisible by
  the 'data' size of every tensor with at least ``FSDP_MIN_SIZE`` elements.
- ``pp=True`` puts the encoder's layers over 'pipe' (``layer_axis``) and
  nothing else.

The layouts differ: a JAX Dense kernel is (in, out) and ``nn.Linear.weight``
is (out, in), so JAX's last dim is the port's dim 0; and the JAX encoder
stacks its layers on a leading axis that the port's per-layer tensors do
not have. The rule therefore runs on the JAX form of each tensor (its
``ckpt/convert.jax_leaf`` path and shape, the stacked size included), and
the result is mapped back.

``ParallelContext`` (``shard_model``) holds what a sharded model needs:
the mesh, each block's ``TensorParallel`` on 'model', and where each
parameter lives. Each rank holds only its slices as the parameters
(``cuts``): q/k/v/fc1's rows and attn_out/fc2's columns over 'model'
(``_tp_layout``; bottleneck adapters, which ``param_spec`` splits too, act
on the summed output and stay whole), under FSDP the ``param_spec`` dim
over 'data', and under pp only the layers of its own stage (``owner``; the
others are empty). So
the optimizer's moments and the update are this rank's slices too. FSDP
gathers each block's parameters whole for its forward (``install_gather``:
an all-gather whose backward reduce-scatters the gradient), the way JAX's
GSPMD gathers a sharded kernel for its product. The gradients are summed
over the batch shards (``reduce_grads``). ``model.state_dict()`` gathers
whole tensors and ``model.load_state_dict`` slices them (hooks), so files
and host copies keep the one-process layout; a sharded checkpoint
(``ckpt/sharded.py``) takes each rank's own slices (``local_view``).
"""

import contextlib
import dataclasses
import functools
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from climb_tpu_torch.ckpt.convert import jax_leaf
from climb_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, REPLICA_AXIS, Mesh
from climb_tpu_torch.parallel.tensor_parallel import TensorParallel

_COL_SPLIT = {"q", "k", "v", "fc1"}  # JAX kernel (..., in, out): split out
_ROW_SPLIT = {"attn_out", "fc2"}     # split in

# Leaves smaller than this stay replicated under FSDP (the JAX package's value).
FSDP_MIN_SIZE = 65536


@dataclasses.dataclass(frozen=True)
class Spec:
    """``dims``: one mesh axis name or None per dim of the port's tensor;
    ``layer_axis``: the axis a per-layer tensor's layer index splits over
    (``pipe`` under pp), else None."""

    dims: Tuple[Optional[str], ...]
    layer_axis: Optional[str] = None


def jax_param_spec(names: Tuple[str, ...], shape: Tuple[int, ...], fsdp_size: int = 0,
                   pp: bool = False) -> tuple:
    """``climb_tpu.parallel.sharding.param_spec`` on a JAX path and shape:
    the PartitionSpec's entries as a tuple (``()`` when replicated)."""
    dims = [None] * len(shape)
    if pp:
        if "encoder" in names and len(shape) >= 1:
            dims[0] = PIPE_AXIS
            return tuple(dims)
        return ()
    if len(names) >= 2 and names[-1] == "kernel":
        owner = names[-2]
        if owner in _COL_SPLIT or owner == "down":
            dims[-1] = MODEL_AXIS
        elif owner in _ROW_SPLIT or owner == "up":
            dims[-2] = MODEL_AXIS
    if len(names) >= 2 and names[-1] == "bias" and names[-2] in _COL_SPLIT:
        dims[-1] = MODEL_AXIS
    size = 1
    for s in shape:
        size *= s
    if fsdp_size > 1 and size >= FSDP_MIN_SIZE:
        first = 1 if len(shape) >= 3 else 0
        cands = [d for d in range(first, len(shape))
                 if dims[d] is None and shape[d] % fsdp_size == 0]
        if cands:
            dims[max(cands, key=lambda d: shape[d])] = DATA_AXIS
    if all(d is None for d in dims):
        return ()
    return tuple(dims)


def param_spec(name: str, shape, num_layers: int, fsdp_size: int = 0,
               pp: bool = False) -> Spec:
    """The split of the port's parameter ``name`` of ``shape``; ``num_layers``
    is the stacked depth of the encoder it belongs to (the JAX leaf's
    leading axis)."""
    path, layer, transposed = jax_leaf(name, shape)
    jshape = tuple(reversed(shape)) if transposed else tuple(shape)
    if layer is not None:
        jshape = (num_layers,) + jshape
    jspec = jax_param_spec(path, jshape, fsdp_size, pp)
    dims = list(jspec) + [None] * (len(jshape) - len(jspec))
    layer_axis = None
    if layer is not None:
        layer_axis, dims = dims[0], dims[1:]
    if transposed:
        dims = dims[::-1]
    return Spec(tuple(dims), layer_axis)


def _stack_of(name: str) -> Optional[str]:
    """The prefix of the layer stack a per-layer parameter belongs to
    ('vilt.encoder', 'viltbert.bert.encoder', ...), else None."""
    m = re.match(r"(.*?encoder)\.(\d+)\.", name)
    return m.group(1) if m else None


def stack_depths(names) -> Dict[str, int]:
    """Layer count of every stack among ``names``."""
    depth: Dict[str, int] = {}
    for n in names:
        m = re.match(r"(.*?encoder)\.(\d+)\.", n)
        if m:
            depth[m.group(1)] = max(depth.get(m.group(1), 0), int(m.group(2)) + 1)
    return depth


def to_jax_spec(spec: Spec, name: str, shape) -> tuple:
    """``spec`` in the JAX leaf's form (stacked layer axis first, kernels
    (in, out)), ``()`` when replicated: the inverse of ``param_spec``'s mapping."""
    _, layer, transposed = jax_leaf(name, shape)
    dims = list(spec.dims)
    if transposed:
        dims = dims[::-1]
    if layer is not None:
        dims = [spec.layer_axis] + dims
    return () if all(d is None for d in dims) else tuple(dims)


def _lora_target(module_name: str) -> Optional[str]:
    """The projection a LoRA module (``adapters.lora_name``) targets."""
    for target in sorted(_COL_SPLIT | _ROW_SPLIT, key=len, reverse=True):
        if module_name.startswith(f"adapter_lora_{target}_"):
            return target
    return None


def _encoder_stack(model, encoder_key: str):
    """(the ViLT encoder's ``ModuleList``, its parameters' name prefix)."""
    core = model.encoder if hasattr(model, "encoder") else model
    vilt = getattr(core, "vilt", core)  # ViLT-BERT's ViLT side
    return vilt, encoder_key + (".vilt" if vilt is not core else "") + ".encoder"


def _tp_layout(model, encoder_key: str):
    """({name: dim} of the parameters each 'model' rank holds a slice of,
    {names} whose gradient each rank computes in part and which are summed
    over 'model'). Sliced: q/k/v/fc1's rows and biases, attn_out/fc2's
    columns, LoRA's ``lora_b`` columns on a column-split target and
    ``lora_a`` rows on a row-split one. Summed: the other LoRA factor, and
    LN1 under the fused sublayer (its gradient comes from the rank's heads)."""
    from climb_tpu_torch.models.vilt_core import fused_block_ok

    cut, partial = {}, set()
    vilt, prefix = _encoder_stack(model, encoder_key)
    for i, block in enumerate(vilt.encoder):
        fused = fused_block_ok(block.cfg, block.adapter_spec)
        for n, _ in block.named_parameters():
            parts = n.split(".")
            name = f"{prefix}.{i}.{n}"
            if parts[0] in _COL_SPLIT:
                cut[name] = 0
            elif parts[0] in _ROW_SPLIT:
                if parts[1] == "weight":
                    cut[name] = 1
            elif parts[0].startswith("adapter_lora_"):
                col = _lora_target(parts[0]) in _COL_SPLIT
                if (parts[1] == "lora_b") == col:
                    cut[name] = 1 if col else 0
                else:
                    partial.add(name)
            elif fused and parts[0] == "ln1":
                partial.add(name)
    return cut, partial


class _GatherData(torch.autograd.Function):
    """The whole tensor from every 'data' rank's FSDP slice (all-gather along
    ``dim``); backward: the whole gradient's sum over the ranks, each taking
    its slice (reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _all_gather(t, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    mine = t.detach().movedim(dim, 0).contiguous()
    whole = mine.new_empty((mine.shape[0] * n,) + mine.shape[1:])
    dist.all_gather_into_tensor(whole, mine, group=group)
    return whole.movedim(0, dim).contiguous()


def _reduce_scatter(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    flat = g.movedim(dim, 0).contiguous()
    out = flat.new_empty((flat.shape[0] // n,) + flat.shape[1:])
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out.movedim(0, dim).contiguous()


class ParallelContext:
    """A model's place on a mesh: see the module docstring."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, fsdp: bool = False, pp: bool = False):
        self.mesh = mesh
        n_model = mesh.size(MODEL_AXIS)
        self.tp = (TensorParallel(mesh.group(MODEL_AXIS), mesh.coord(MODEL_AXIS), n_model)
                   if n_model > 1 else None)
        encoder_key = getattr(model, "encoder_key", "vilt")
        fsdp_size = mesh.size(DATA_AXIS) if fsdp else 0
        named = dict(model.named_parameters())
        depth = stack_depths(named)
        specs = {n: param_spec(n, tuple(p.shape), depth.get(_stack_of(n), 0), fsdp_size, pp)
                 for n, p in named.items()}
        self.shapes = {n: tuple(p.shape) for n, p in named.items()}
        tp_cut, self.model_sum = _tp_layout(model, encoder_key) if self.tp else ({}, set())
        self.cuts: Dict[str, Tuple[Tuple[int, str], ...]] = {}
        for n, spec in specs.items():
            cuts = [(tp_cut[n], MODEL_AXIS)] if n in tp_cut else []
            if fsdp_size > 1 and DATA_AXIS in spec.dims:
                cuts.append((spec.dims.index(DATA_AXIS), DATA_AXIS))
            self.cuts[n] = tuple(cuts)
        # under pp, the stage that holds each layer of the pipelined stack
        self.owner: Dict[str, int] = {}
        n_pipe = mesh.size(PIPE_AXIS)
        if pp and n_pipe > 1:
            vilt, prefix = _encoder_stack(model, encoder_key)
            per = len(vilt.encoder) // (n_pipe * vilt.cfg.pp_virtual)
            for i, block in enumerate(vilt.encoder):
                for n, _ in block.named_parameters():
                    self.owner[f"{prefix}.{i}.{n}"] = (i // per) % n_pipe
        self._units: Dict[torch.nn.Module, list] = {}
        self._depth: Dict[torch.nn.Module, int] = {}
        self._saved: Dict[torch.nn.Module, list] = {}
        self._local_view = False

    # -- where each parameter lives ------------------------------------------
    def fsdp_dim(self, name: str) -> Optional[int]:
        """The dim of ``name`` split over 'data' (FSDP), else None."""
        return next((d for d, a in self.cuts.get(name, ()) if a == DATA_AXIS), None)

    def held_index(self, name: str, shape=None) -> Optional[tuple]:
        """The slices of the whole tensor ``name`` that this rank holds (None
        when another pipeline stage holds it); ``shape`` is the whole shape of
        a tensor the context does not know (a buffer: held whole)."""
        shape = self.shapes.get(name, shape)
        if self.owner.get(name, self.mesh.coord(PIPE_AXIS)) != self.mesh.coord(PIPE_AXIS):
            return None
        index = [slice(0, s) for s in shape]
        for dim, axis in self.cuts.get(name, ()):
            w = shape[dim] // self.mesh.size(axis)
            index[dim] = slice(self.mesh.coord(axis) * w, (self.mesh.coord(axis) + 1) * w)
        return tuple(index)

    def writes(self, name: str) -> bool:
        """True on the one rank among the holders of this rank's slice of
        ``name`` that writes it to a sharded checkpoint (JAX's
        ``replica_id == 0``)."""
        held = {a for _, a in self.cuts.get(name, ())} | ({PIPE_AXIS} if name in self.owner
                                                          else set())
        return (self.owner.get(name, self.mesh.coord(PIPE_AXIS)) == self.mesh.coord(PIPE_AXIS)
                and all(self.mesh.coord(a) == 0 for a in self.mesh.axis_names if a not in held))

    def _copies(self, name: str) -> int:
        """The ranks that hold each element of ``name``."""
        n = self.mesh.world
        for _, axis in self.cuts.get(name, ()):
            n //= self.mesh.size(axis)
        return n // self.mesh.size(PIPE_AXIS) if name in self.owner else n

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``whole`` of parameter
        ``name`` (a new tensor; empty when another stage holds it)."""
        index = self.held_index(name, tuple(whole.shape))
        if index is None:
            return whole.new_empty((0,))
        return whole[index].contiguous().clone()

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor ``name`` from every rank's slice ``t``: gathered
        over its split axes, and under pp broadcast from its stage. Every rank
        calls it, for the same names in the same order."""
        t = t.detach()
        for dim, axis in self.cuts.get(name, ()):
            t = _all_gather(t, dim, self.mesh.group(axis), self.mesh.size(axis))
        if name in self.owner:
            group = self.mesh.group(PIPE_AXIS)
            mine = self.owner[name] == self.mesh.coord(PIPE_AXIS)
            t = t.contiguous() if mine else t.new_empty(self.shapes[name])
            dist.broadcast(t, src=dist.get_global_rank(group, self.owner[name]), group=group)
        return t

    def localize(self, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``state_dict`` with every whole parameter replaced by this rank's
        slice (tensors already of the local shape, and other names, kept)."""
        return {n: self.local(n, t) if self._sliced_whole(n, t) else t
                for n, t in state_dict.items()}

    def _sliced_whole(self, name: str, t: torch.Tensor) -> bool:
        """True when ``t`` is the whole tensor of a parameter this rank holds
        only a slice of."""
        if name not in self.shapes or tuple(t.shape) != self.shapes[name]:
            return False
        index = self.held_index(name)
        return index is None or any(s.stop - s.start != n
                                    for s, n in zip(index, self.shapes[name]))

    @contextlib.contextmanager
    def local_view(self):
        """``model.state_dict()`` gives this rank's slices for the duration
        (no gather)."""
        self._local_view = True
        try:
            yield
        finally:
            self._local_view = False

    def _state_dict_hook(self, module, state_dict, prefix, local_metadata):
        if self._local_view:
            return
        for n in self.shapes:
            if prefix + n in state_dict:
                state_dict[prefix + n] = self.full(n, state_dict[prefix + n])

    def _load_hook(self, state_dict, prefix, *args):
        for n in self.shapes:
            if prefix + n in state_dict and self._sliced_whole(n, state_dict[prefix + n]):
                state_dict[prefix + n] = self.local(n, state_dict[prefix + n])

    # -- FSDP: gathering a module's parameters for its forward ---------------
    def install_gather(self, root: torch.nn.Module, units):
        """Each of ``units`` (the blocks) gathers its FSDP-split parameters
        whole for its forward, and ``root`` (the learner) the rest; the
        gathered tensors live for the forward and what autograd keeps of it
        (a rematerialized block gathers again in its recompute)."""
        names = {m: n for n, m in root.named_modules()}
        in_unit = set()
        for unit in list(units) + [root]:
            entries = []
            for mname, mod in unit.named_modules():
                if mod in in_unit or (mname and mod in units):
                    continue
                in_unit.add(mod)
                for pname, _ in mod.named_parameters(recurse=False):
                    name = f"{names[mod]}.{pname}" if names[mod] else pname
                    if self.fsdp_dim(name) is not None:
                        entries.append((mod, pname, name))
            self._units[unit] = entries
            unit.register_forward_pre_hook(lambda m, a: self._enter(m))
            unit.register_forward_hook(lambda m, a, o: self._exit(m), always_call=True)
            if unit is not root:
                unit.gathered = functools.partial(self.gathered, unit)

    def _enter(self, unit):
        depth = self._depth.get(unit, 0)
        self._depth[unit] = depth + 1
        if depth:
            return
        saved = []
        group, n = self.mesh.group(DATA_AXIS), self.mesh.size(DATA_AXIS)
        for mod, pname, name in self._units.get(unit, ()):
            t = mod._parameters[pname]
            saved.append((mod, pname, t))
            mod._parameters[pname] = _GatherData.apply(t, self.fsdp_dim(name), group, n)
        self._saved[unit] = saved

    def _exit(self, unit):
        self._depth[unit] -= 1
        if self._depth[unit]:
            return
        for mod, pname, t in self._saved.pop(unit):
            mod._parameters[pname] = t

    @contextlib.contextmanager
    def gathered(self, unit):
        self._enter(unit)
        try:
            yield
        finally:
            self._exit(unit)

    # -- reductions ----------------------------------------------------------
    @property
    def batch_group(self):
        return self.mesh.batch_group

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the batch shards (a new tensor)."""
        t = t.detach().clone()
        if self.mesh.batch_size > 1:
            dist.all_reduce(t, group=self.batch_group)
        return t

    def tree_sum(self, terms: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum over the whole parameters of per-parameter sums ``terms``
        that each rank computed on its slices (every element counted once)."""
        total = sum(t.detach() / self._copies(n) for n, t in terms.items())
        total = torch.as_tensor(total, dtype=torch.float32,
                                device=next(iter(terms.values())).device).clone()
        if self.mesh.world > 1:
            dist.all_reduce(total)
        return total

    def all_finite(self, tensors) -> bool:
        flag = torch.stack([torch.isfinite(t).all() for t in tensors]).all().to(torch.float32)
        if self.mesh.world > 1:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag)

    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole batch's gradients of this rank's slices, in place: summed
        over 'model' for the parameters whose gradient each model rank
        computes in part, and over the batch shards (the loss is already
        divided by the global valid count). An FSDP slice's gradient arrives
        summed over 'data' (the gather's backward), and only 'replica' is
        left."""
        out = {}
        for n, g in grads.items():
            out[n] = g = g.contiguous()
            if g.numel() == 0:  # a layer of another pipeline stage
                continue
            if n in self.model_sum:
                dist.all_reduce(g, group=self.mesh.group(MODEL_AXIS))
            if self.fsdp_dim(n) is None:
                if self.mesh.batch_size > 1:
                    dist.all_reduce(g, group=self.batch_group)
            elif self.mesh.size(REPLICA_AXIS) > 1:
                dist.all_reduce(g, group=self.mesh.group(REPLICA_AXIS))
        return out

    # -- batches -------------------------------------------------------------
    def shard_rows(self, batch: dict) -> dict:
        """This rank's contiguous share of a batch every rank holds whole."""
        n = self.mesh.batch_size
        if n == 1:
            return batch
        i = self.mesh.batch_coord
        out = {}
        for k, v in batch.items():
            if getattr(v, "ndim", 0) == 0:
                out[k] = v
                continue
            if v.shape[0] % n:
                raise ValueError(f"batch of {v.shape[0]} rows does not split over {n} data "
                                 "ranks")
            w = v.shape[0] // n
            out[k] = v[i * w:(i + 1) * w]
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every batch shard's rows of ``t``, in rank order (each rank's share
        of one batch: equal leading sizes)."""
        n = self.mesh.batch_size
        if n == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=self.batch_group)
        return torch.cat(parts)


def shard_model(model: torch.nn.Module, mesh: Optional[Mesh], fsdp: bool = False,
                pp: bool = False):
    """Place ``model`` on ``mesh``: every rank starts from rank 0's parameters
    (a broadcast) and keeps only its slices of them, the blocks learn their
    'model' shard, under FSDP each block gathers its parameters for its
    forward, and ``model.parallel`` holds the ``ParallelContext``.
    ``model.state_dict()`` then gathers whole tensors (every rank calls it)
    and ``model.load_state_dict`` takes whole ones. ``mesh`` None leaves a
    single-process model untouched."""
    if mesh is None:
        model.parallel = None
        return model
    replicate(model, mesh)
    ctx = ParallelContext(model, mesh, fsdp=fsdp, pp=pp)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.data = ctx.local(n, p.data)
    vilt, _ = _encoder_stack(model, getattr(model, "encoder_key", "vilt"))
    for block in vilt.encoder:
        block.tp = ctx.tp
    if pp:
        vilt.pipe = mesh.group(PIPE_AXIS)
    if any(ctx.fsdp_dim(n) is not None for n in ctx.shapes):
        ctx.install_gather(model, list(vilt.encoder))
    model._register_state_dict_hook(ctx._state_dict_hook)
    model._register_load_state_dict_pre_hook(ctx._load_hook)
    model.parallel = ctx
    return model


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: Mesh):
    """Broadcast rank 0's parameters and buffers to every rank."""
    if mesh.world == 1:
        return
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=0)


def shard_batch(batch: dict, model) -> dict:
    """This rank's rows of a batch that every rank holds whole (the replay
    batch, drawn alike on every rank); the batch itself without a mesh."""
    ctx = getattr(model, "parallel", None)
    return batch if ctx is None else ctx.shard_rows(batch)
