"""The train step factory, and the sharding trees of its state.

The port of ``repro.train.train_step``.  ``make_train_step`` gives
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``:
the loss and its backward (autograd through ``Model.loss``, under the
model's ``remat``), then one AdamW update in place.  With ``microbatches
> 1`` the batch splits along dim 0 and the f32 gradients accumulate as
``acc + g / microbatches`` in order, as the reference's ``lax.scan``
does; the loss and every metric are the mean over microbatches.  With
``compressed_grads`` and a mesh that has a ``data`` axis, the gradients
go through ``distributed.collectives.compressed_psum_tree`` over that
axis (int8 on the wire, error feedback carried in ``opt_state.ef``)
before the update, the reference's condition.

``_opt_axes`` and ``tree_shardings`` resolve the logical axes of the
parameters, optimizer state and batches into DTensor placements under a
``MeshRules`` (``distributed.sharding``).

``lower_train_step`` / ``lower_serve_step`` serve the dry-run
(``launch/dryrun.py``).  The reference lowers the jitted step for XLA's
analyses; eager torch has no lowering, so they return a ``Lowered``: the
step on ``meta`` tensors, counted by ``launch/cost.py``, beside the
per-rank bytes of its arguments and outputs (shard shapes of the
reference's trees under the resolved specs) and its collective bytes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed.collectives import ShapeOnlyGroup, compressed_psum_tree
from ..distributed.sharding import MeshRules, use_rules
from ..models.params import _tree_key, logical_axes
from .optimizer import AdamWConfig, AdamWState, apply_update, init_state


def tree_shardings(rules: MeshRules, structs, axes):
    """Resolve a tree of tensors (``meta`` ones included) and its
    logical-axes tree -> a tree of DTensor placements (one per mesh axis);
    a leaf whose axes are ``()`` or None is replicated.  Dicts, tuples
    and NamedTuples nest; ``structs`` gives the structure."""
    if hasattr(structs, "shape"):
        if axes == () or axes is None:
            return rules.sharding(structs.shape, (None,) * len(structs.shape))
        return rules.sharding(structs.shape, axes, tag=str(axes))
    if isinstance(structs, dict):
        return {k: tree_shardings(rules, v, axes[k])
                for k, v in structs.items()}
    if isinstance(structs, tuple):
        vals = [tree_shardings(rules, s, a) for s, a in zip(structs, axes)]
        return type(structs)(*vals) if hasattr(structs, "_fields") \
            else tuple(vals)
    raise TypeError(f"not a tensor tree: {type(structs).__name__}")


def _opt_axes(model, opt_cfg: AdamWConfig, zero1: bool = False):
    """The optimizer state's logical axes (``AdamWState`` of name-keyed
    dicts).  ``zero1``: the moments, master and residuals shard their
    d_model dims over "data" (``opt_embed``) even where the parameters
    replicate over it."""
    param_axes = model.axes()
    if zero1:
        param_axes = {n: tuple("opt_embed" if a == "embed" else a
                               for a in ax)
                      for n, ax in param_axes.items()}
    low_prec = model.cfg.param_dtype != "f32"
    return AdamWState(
        step=(),
        m=param_axes,
        v=param_axes,
        master=(param_axes if (opt_cfg.use_master and low_prec) else ()),
        ef=(param_axes if opt_cfg.error_feedback else ()),
    )


def _split(x, n: int):
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [x[i * (b // n):(i + 1) * (b // n)] for i in range(n)]


def _grads(model, batch):
    """loss, metrics (detached) and ``{name: grad or None}`` of one
    backward from zeroed gradients."""
    model.zero_grad(set_to_none=True)
    loss, metrics = model.loss(batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def compressed_grads_by_leaf(params, grads, ef, mesh, axis: str = "data"):
    """``compressed_psum_tree`` over ``axis`` per leaf of the reference's
    tree: the parameters of one stacked layer leaf (``layers.{i}.attn.wq``
    for every i) go through as one ``(L, ...)`` tensor, so they share its
    two scales, as in the reference.  ``grads`` and ``ef`` (or ``()``)
    are keyed by parameter name; a ``None`` gradient is zeros (JAX's
    gradient of a parameter the loss does not read).  Returns (the mean
    gradients, the new residuals), keyed by parameter name."""
    groups: Dict[tuple, list] = {}
    for name in params:
        groups.setdefault(_tree_key(name)[0], []).append(name)

    def stack(values, names):
        ts = [values[n] if values[n] is not None else torch.zeros(
            params[n].shape, dtype=torch.float32, device=params[n].device)
            for n in names]
        return ts[0] if len(ts) == 1 else torch.stack(ts)

    g = {k: stack(grads, ns) for k, ns in groups.items()}
    e = () if ef == () else {k: stack(ef, ns) for k, ns in groups.items()}
    out, new_ef = compressed_psum_tree(g, e, mesh, axis=axis)

    def unstack(tree):
        res = {}
        for k, ns in groups.items():
            for i, n in enumerate(ns):
                res[n] = tree[k] if len(ns) == 1 else tree[k][i]
        return res
    return unstack(out), unstack(new_ef)


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    compressed_grads: bool = False, mesh=None):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``metrics`` holds the loss's (``ce``, ``loss``,
    ``aux_loss``, ``expert_load`` for MoE), ``lr``, ``grad_norm`` and
    ``loss_out``.

    ``compressed_grads`` with a ``mesh`` (``launch.mesh.HostMesh``) that
    has a ``data`` axis averages the gradients over that axis through the
    int8 compressed all-reduce, carrying the residuals in
    ``opt_state.ef`` (``()`` means zeros); without a mesh, or with no
    ``data`` axis, it is a no-op, as in the reference.  Each data rank's
    gradient is the one its own batch gives it: with the same batch on
    every rank this is the reference's replicated input, and the two
    agree.  A parameter the loss does not read enters as zeros (JAX's
    gradient there)."""
    compress = (compressed_grads and mesh is not None
                and "data" in mesh.shape)

    def compute_grads(model, batch):
        if microbatches == 1:
            return _grads(model, batch)
        parts = {k: _split(v, microbatches) for k, v in batch.items()}
        acc, losses, metricses = None, [], []
        for i in range(microbatches):
            loss, metrics, grads = _grads(
                model, {k: v[i] for k, v in parts.items()})
            with torch.no_grad():
                if acc is None:
                    acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for n, p in model.named_parameters()}
                for n, g in grads.items():
                    if g is not None:
                        acc[n] = acc[n] + g.float() / microbatches
            losses.append(loss)
            metricses.append(metrics)
        metrics = {k: torch.stack([m[k] for m in metricses]).mean(dim=0)
                   for k in metricses[0]}
        return torch.stack(losses).mean(), metrics, acc

    def train_step(model, opt_state: AdamWState, batch: Dict[str, Any]):
        loss, metrics, grads = compute_grads(model, batch)
        params = dict(model.named_parameters())
        if compress:
            grads, ef = compressed_grads_by_leaf(params, grads,
                                                 opt_state.ef, mesh)
            opt_state = opt_state._replace(ef=ef)
        _, opt_state, om = apply_update(opt_cfg, params, grads, opt_state)
        return model, opt_state, {**metrics, **om, "loss_out": loss}

    return train_step


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``data.lm_data.make_batch``) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The dry-run's lowering
# ---------------------------------------------------------------------------

_BATCH_AXES = ("pod", "data")


class ShapeMesh:
    """A mesh that is only its shape (``{axis name: size}``, what
    ``MeshRules`` reads), for meshes of more ranks than the host has: the
    dry-run's production meshes.  ``get_group`` gives a
    ``ShapeOnlyGroup``, so the compressed all-reduce's arithmetic runs on
    ``meta`` tensors with no process group."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self._groups: Dict[str, ShapeOnlyGroup] = {}

    def get_group(self, axis: str) -> ShapeOnlyGroup:
        if axis not in self._groups:
            self._groups[axis] = ShapeOnlyGroup(self.shape[axis])
        return self._groups[axis]


def _ref_leaves(structs, axes):
    """(tensor, axes) pairs in the reference's tree order: dict keys
    sorted (jax's flatten order), tuple fields in order; an empty ``()``
    subtree has none."""
    if hasattr(structs, "shape"):
        yield structs, axes
    elif isinstance(structs, dict):
        for k in sorted(structs):
            yield from _ref_leaves(structs[k], axes[k])
    elif isinstance(structs, tuple):
        for s, a in zip(structs, axes):
            yield from _ref_leaves(s, a)


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    return fn(tree)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _resolve(rules: MeshRules, t, axes) -> tuple:
    """A leaf's spec, as the reference's ``tree_shardings`` resolves it
    (``()`` or None: replicated, with no fallback recorded)."""
    if axes == () or axes is None:
        return (None,) * len(t.shape)
    return tuple(rules.resolve(t.shape, axes, tag=str(axes)))


def _parts(part) -> tuple:
    return (part,) if isinstance(part, str) else tuple(part or ())


def _shard_bytes(t, spec, mesh_shape) -> int:
    """Bytes of one rank's shard of ``t`` under ``spec`` (the
    resolver only shards dims that divide evenly)."""
    n = 1
    for dim, part in zip(t.shape, spec):
        n *= dim // math.prod(mesh_shape[a] for a in _parts(part))
    return n * t.element_size()


def _split_of(spec, mesh_shape, axes=None) -> int:
    """How many ways ``spec`` splits a tensor (over ``axes`` only, if
    given)."""
    return math.prod(mesh_shape[a] for part in spec for a in _parts(part)
                     if axes is None or a in axes)


def _ref_params(cfg):
    """The reference's parameter tree (layer leaves stacked ``(L, ...)``)
    as ``meta`` tensors, and its logical axes."""
    from ..models.model import param_defs

    defs = param_defs(cfg)
    return (_tmap(lambda d: _meta(d.shape, cfg.pdtype), defs),
            logical_axes(defs))


def _ref_opt(cfg, opt_cfg: AdamWConfig, params, axes, zero1: bool):
    """The reference's ``AdamWState`` of ``params`` (``jax.eval_shape`` of
    ``init_state``) and its logical axes (``_opt_axes``)."""
    if zero1:
        axes = _tmap(lambda ax: tuple("opt_embed" if a == "embed" else a
                                      for a in ax), axes)
    f32 = _tmap(lambda t: _meta(t.shape, torch.float32), params)
    low_prec = cfg.param_dtype != "f32"
    master = opt_cfg.use_master and low_prec
    return (AdamWState(step=_meta((), torch.int32), m=f32, v=f32,
                       master=f32 if master else (),
                       ef=f32 if opt_cfg.error_feedback else ()),
            AdamWState(step=(), m=axes, v=axes, master=axes if master else (),
                       ef=axes if opt_cfg.error_feedback else ()))


class Lowered:
    """The port's stand-in for the reference's lowered step: the reads the
    dry-run makes of it, per rank.

    * ``cost_analysis()``: ``{"flops", "bytes accessed"}`` of the global
      step run on ``meta`` tensors (``launch/cost.py``), divided by the
      chip count: it assumes the work splits evenly over the ranks.
    * ``memory_analysis()``: ``argument_size_in_bytes``,
      ``output_size_in_bytes`` and ``alias_size_in_bytes`` are sums of
      shard shapes under the resolved specs (donated outputs alias their
      arguments, as the reference donates them); ``temp_size_in_bytes``
      is the peak of the storages the step makes (the arguments are not
      among them), run at the rank's batch share and full width.  Where
      the ``model`` axis is larger than 1 this is an upper bound: the
      port has no tensor-parallel execution, so the rank runs every
      head, expert and vocabulary row.
    * ``collectives()``: ``{kind: bytes}`` per rank, output operand
      bytes under the reference's kind names: ``exact_collectives()``
      (what the port's own distributed code sends) plus the formulas of
      ``_modelled_collectives`` for the reference's layout, which the
      port does not execute.  ``collectives_by_axis()`` splits the same
      bytes by the mesh axes they cross.
    """

    def __init__(self, n_chips: int, run_global, run_local, memory: dict,
                 exact: dict, modelled: dict, by_axis: dict):
        self.n_chips = n_chips
        self._run_global = run_global
        self._run_local = run_local
        self._memory = memory
        self._exact = exact
        self._modelled = modelled
        self._by_axis = by_axis
        self._cost = None
        self._temp = None

    def cost_analysis(self) -> Dict[str, float]:
        if self._cost is None:
            flops, nbytes = self._run_global()
            self._cost = {"flops": flops / self.n_chips,
                          "bytes accessed": nbytes / self.n_chips}
        return dict(self._cost)

    def memory_analysis(self) -> Dict[str, int]:
        if self._temp is None:
            self._temp = int(self._run_local())
        return dict(self._memory, temp_size_in_bytes=self._temp)

    def exact_collectives(self) -> Dict[str, int]:
        return dict(self._exact)

    def collectives(self) -> Dict[str, int]:
        out = dict(self._modelled)
        for k, v in self._exact.items():
            out[k] = out.get(k, 0) + v
        return {k: v for k, v in out.items() if v}

    def collectives_by_axis(self) -> Dict[str, int]:
        return {k: v for k, v in self._by_axis.items() if v}


class _Wire:
    """Collective bytes per kind and per axis group, as the lowering adds
    them up."""

    def __init__(self):
        self.kinds: Dict[str, int] = {}
        self.axes: Dict[str, int] = {}

    def add(self, kind: str, axes: Tuple[str, ...], nbytes) -> None:
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        self.kinds[kind] = self.kinds.get(kind, 0) + nbytes
        key = "+".join(axes)
        self.axes[key] = self.axes.get(key, 0) + nbytes


def _compressed_bytes(wire: _Wire, model, mesh_shape) -> None:
    """What ``compressed_grads_by_leaf`` sends per rank over the ``data``
    axis: its exchanges run once on ``meta`` gradients over a
    ``ShapeOnlyGroup``, which logs each one's output bytes."""
    params = dict(_meta_model(model).named_parameters())
    mesh = ShapeMesh(mesh_shape)
    compressed_grads_by_leaf(params, dict.fromkeys(params), (), mesh)
    for kind, nbytes in mesh.get_group("data").sent.items():
        wire.add(kind, ("data",), nbytes)


def _ep_applies(cfg, mesh_shape, batch: int) -> bool:
    """``moe_ffn``'s test for the expert-parallel path."""
    m = mesh_shape.get("model", 1)
    n_dp = math.prod(mesh_shape.get(a, 1) for a in _BATCH_AXES)
    return (cfg.family == "moe" and m > 1 and cfg.n_experts % m == 0
            and batch % n_dp == 0)


def _ep_bytes(wire: _Wire, cfg, mesh_shape, batch: int, seq: int,
              passes: int) -> None:
    """``_moe_ffn_ep``'s two ``all_to_all``s per MoE layer and pass: each
    moves the rank's ``(E, C, D)`` buffer (C the capacity of the tokens
    it dispatches)."""
    from ..models.moe import capacity

    m = mesh_shape["model"]
    n_dp = math.prod(mesh_shape.get(a, 1) for a in _BATCH_AXES)
    t_loc = batch // n_dp * seq
    t_disp = t_loc // m if (cfg.moe_seq_shard and t_loc % m == 0) else t_loc
    c = capacity(cfg, t_disp)
    per = cfg.n_experts * c * cfg.d_model * _meta((), cfg.adtype) \
        .element_size()
    wire.add("all-to-all", ("model",), 2 * passes * cfg.n_layers * per)


def _modelled_collectives(wire: _Wire, cfg, rules: MeshRules, kind: str,
                          remat: str, b_loc: int, seq: int, params, p_axes,
                          opt_axes, compressed: bool, cache_len: int = 0
                          ) -> None:
    """The reference's layout's collectives that the port does not execute,
    per rank, one formula per term (``rules`` resolves with the
    production table; nothing is recorded in its fallbacks):

    * FSDP all-gathers: each parameter with dims sharded over the batch
      axes is gathered along them once per forward, and again for the
      recompute under remat "full" (output: the leaf over its non-batch
      split);
    * gradients (train, batch axes larger than 1): a reduce-scatter into
      the optimizer state's shard where that shard splits over the batch
      axes (output: the shard), else an all-reduce of the parameter's
      shard; ZeRO-1's updated parameters are all-gathered back over the
      batch axes.  With ``compressed`` the gradients' exchange is the
      port's own over ``data`` (``_compressed_bytes``) instead (a "pod"
      axis's share of it is not modelled);
    * activation all-reduces after the ``model``-split attention output,
      dense FFN (and shared experts), and SSM output projection: (B_loc,
      S, D) activations once per block in a forward, and in a train step
      once more for the input gradient and once for the recompute under
      remat;
    * the vocabulary-split embedding lookup (one activation all-reduce
      per forward) and loss (max, sum and gold logit: three (B_loc, S)
      f32 all-reduces, and the unembedding's input gradient);
    * split-``cache_seq`` decode: per attention call, the partial
      softmax's max and sum and its (B_loc, H, hd) f32 output.
    """
    rules = MeshRules(mesh=rules.mesh, rules=rules.rules)
    ms = rules.mesh.shape
    batch_axes = tuple(a for a in _BATCH_AXES if a in ms)
    n_dp = math.prod(ms[a] for a in batch_axes)
    m = ms.get("model", 1)
    train = kind == "train"
    act = b_loc * seq * cfg.d_model * _meta((), cfg.adtype).element_size()

    gathers = 2 if (train and remat == "full") else 1
    for (t, ax), (_, oax) in zip(_ref_leaves(params, p_axes),
                                 _ref_leaves(params, opt_axes)):
        spec = _resolve(rules, t, ax)
        whole = t.numel() * t.element_size()
        split_all = _split_of(spec, ms)
        split_dp = _split_of(spec, ms, batch_axes)
        if split_dp > 1:
            wire.add("all-gather", batch_axes,
                     gathers * whole * split_dp // split_all)
        if not train or n_dp == 1:
            continue
        if compressed:
            continue
        ospec = _resolve(rules, t, oax)
        if _split_of(ospec, ms, batch_axes) > 1:
            wire.add("reduce-scatter", batch_axes,
                     whole // _split_of(ospec, ms))
            if split_dp == 1:
                wire.add("all-gather", batch_axes, whole // split_all)
        else:
            wire.add("all-reduce", batch_axes, whole // split_all)

    if m == 1:
        return
    passes = (2 + (remat != "none")) if train else 1

    def split(name: str, dim: int) -> bool:
        return _split_of(rules.resolve((dim,), (name,)), ms, ("model",)) > 1

    fam = cfg.family
    n_attn = (cfg.n_layers if fam in ("dense", "moe", "vlm", "audio")
              else cfg.n_shared_attn_calls if fam == "hybrid" else 0)
    blocks = n_attn if split("heads", cfg.n_heads) else 0
    if fam in ("dense", "vlm", "audio") and split("ff", cfg.d_ff):
        blocks += cfg.n_layers
    if fam == "hybrid" and split("ff", cfg.d_ff):
        blocks += n_attn
    if (fam == "moe" and cfg.n_shared_experts > 0
            and split("ff", cfg.n_shared_experts * cfg.d_ff)):
        blocks += cfg.n_layers
    if fam in ("ssm", "hybrid") and split("ssm_inner", cfg.d_inner):
        blocks += cfg.n_layers
    wire.add("all-reduce", ("model",), blocks * passes * act)

    if split("vocab", cfg.vocab):
        if not cfg.frontend_is_embedding:
            wire.add("all-reduce", ("model",), act)
        if train:
            wire.add("all-reduce", ("model",), 3 * b_loc * seq * 4 + act)
    if kind == "decode" and n_attn and split("cache_seq", cache_len):
        wire.add("all-reduce", ("model",),
                 n_attn * b_loc * cfg.n_heads * (cfg.hd + 2) * 4)



def _shaped(t, batch: int) -> torch.Tensor:
    return _meta((batch,) + tuple(t.shape[1:]), t.dtype)


def _memory(rules, mesh_shape, args, outs, alias_outs: bool) -> dict:
    """Shard-shape byte sums of (tensor, axes) trees: the arguments (their
    specs recorded in ``rules``, as the reference's ``in_shardings``) and
    the outputs (resolved on a copy, so no fallback is recorded twice)."""
    quiet = MeshRules(mesh=rules.mesh, rules=rules.rules)
    arg = sum(_shard_bytes(t, _resolve(rules, t, ax), mesh_shape)
              for tree, axes in args for t, ax in _ref_leaves(tree, axes))
    out = sum(_shard_bytes(t, _resolve(quiet, t, ax), mesh_shape)
              for tree, axes in outs for t, ax in _ref_leaves(tree, axes))
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "alias_size_in_bytes": out if alias_outs else 0}


def _batch_share(rules, structs, axes) -> int:
    """The rank's share of the batch: the first batch leaf's leading dim
    over its resolved split."""
    quiet = MeshRules(mesh=rules.mesh, rules=rules.rules)
    for t, ax in _ref_leaves(structs, axes):
        if ax and ax[0] == "batch":
            spec = _resolve(quiet, t, ax)
            return t.shape[0] // _split_of(spec[:1], rules.mesh.shape)
    raise ValueError("no batch leaf")


def _meta_model(model):
    from ..models.model import Model

    return Model(model.cfg, device="meta", remat=model.remat,
                 unroll_layers=model.unroll_layers)


def lower_train_step(model, opt_cfg: AdamWConfig, mesh, shape_name: str, *,
                     microbatches: int = 1,
                     rule_overrides: Optional[Dict] = None,
                     compressed_grads: bool = False, zero1: bool = False,
                     donate: bool = True):
    """The train step for (arch x shape x mesh) as a ``Lowered``, and the
    rules it resolved under (their ``fallbacks`` as the reference's).

    ``mesh`` is anything with a ``shape`` mapping (a ``HostMesh``, a
    ``ShapeMesh``).  The specs are resolved over the reference's trees in
    its order: parameters (stacked layer leaves), the optimizer state,
    the batch.  ``zero1``: parameters replicate over "data" while the
    moments and master shard their d_model dims over it (the
    reference's ZeRO-1 layout).  The step itself runs on ``meta`` tensors
    when the ``Lowered`` is read: ``model``'s config and remat, never its
    parameters."""
    from ..launch import cost, shapes as shapes_lib

    cfg = model.cfg
    spec = shapes_lib.SHAPES[shape_name]
    if zero1:
        rule_overrides = {**(rule_overrides or {}), "embed": None}
    with use_rules(mesh, rule_overrides) as rules:
        ms = dict(mesh.shape)
        batch, batch_axes = shapes_lib.input_specs(cfg, shape_name)
        params, p_axes = _ref_params(cfg)
        opt, o_axes = _ref_opt(cfg, opt_cfg, params, p_axes, zero1)
        memory = _memory(rules, ms, [(params, p_axes), (opt, o_axes),
                                     (batch, batch_axes)],
                         [(params, p_axes), (opt, o_axes)], donate)
        b_loc = _batch_share(rules, batch, batch_axes)
        seq = next(iter(batch.values())).shape[1]
        compress = compressed_grads and "data" in ms
        wire = _Wire()
        if compress:
            _compressed_bytes(wire, model, ms)
        if _ep_applies(cfg, ms, spec.global_batch):
            passes = 3 if model.remat != "none" else 2
            _ep_bytes(wire, cfg, ms, spec.global_batch, seq, passes)
        exact = dict(wire.kinds)
        _modelled_collectives(wire, cfg, rules, "train", model.remat, b_loc,
                              seq, params, p_axes, o_axes.m, compress)
    modelled = {k: v - exact.get(k, 0) for k, v in wire.kinds.items()}
    shape_mesh = ShapeMesh(ms)

    def run(rows: Optional[int], counter):
        meta = _meta_model(model)
        state = init_state(opt_cfg, dict(meta.named_parameters()))
        step = make_train_step(meta, opt_cfg, microbatches=microbatches,
                               compressed_grads=compress,
                               mesh=shape_mesh if compress else None)
        b = batch if rows is None else {k: _shaped(v, rows)
                                        for k, v in batch.items()}
        return counter(lambda: step(meta, state, b))

    return Lowered(
        math.prod(ms.values()),
        lambda: run(None, cost.flops_and_bytes),
        lambda: run(b_loc, cost.peak_live_bytes),
        memory, exact, modelled, wire.axes), rules


def lower_serve_step(model, mesh, shape_name: str,
                     rule_overrides: Optional[Dict] = None):
    """Prefill (shape kind "prefill") or decode ("decode") as a
    ``Lowered``, and the rules it resolved under.  Prefill's arguments
    are the parameters and the prompt batch, its outputs the last
    position's logits and the cache; decode's arguments are the
    parameters, the cache (donated: it aliases the new cache) and the
    tokens."""
    from ..launch import cost, shapes as shapes_lib

    cfg = model.cfg
    spec = shapes_lib.SHAPES[shape_name]
    with use_rules(mesh, rule_overrides) as rules:
        ms = dict(mesh.shape)
        params, p_axes = _ref_params(cfg)
        logits = _meta((spec.global_batch, 1, cfg.vocab), cfg.adtype)
        l_axes = ("batch", None, "vocab")
        if spec.kind == "prefill":
            batch, batch_axes = shapes_lib.input_specs(cfg, shape_name)
            cache_len = spec.seq + (cfg.n_frontend_tokens
                                    if cfg.family == "vlm" else 0)
            cache, cache_axes = shapes_lib.cache_specs(
                cfg, spec.global_batch, cache_len)
            memory = _memory(rules, ms, [(params, p_axes),
                                         (batch, batch_axes)],
                             [(logits, l_axes), (cache, cache_axes)], False)
            b_loc = _batch_share(rules, batch, batch_axes)
            seq = next(iter(batch.values())).shape[1]
        elif spec.kind == "decode":
            (cache, tok), (cache_axes, tok_axes) = shapes_lib.input_specs(
                cfg, shape_name)
            memory = _memory(rules, ms, [(params, p_axes),
                                         (cache, cache_axes),
                                         (tok, tok_axes)],
                             [(logits, l_axes), (cache, cache_axes)], False)
            memory["alias_size_in_bytes"] = sum(
                _shard_bytes(t, _resolve(MeshRules(rules.mesh, rules.rules),
                                         t, ax), ms)
                for t, ax in _ref_leaves(cache, cache_axes))
            b_loc = _batch_share(rules, tok, tok_axes)
            seq = 1
        else:
            raise ValueError(spec.kind)
        wire = _Wire()
        if _ep_applies(cfg, ms, spec.global_batch):
            _ep_bytes(wire, cfg, ms, spec.global_batch, seq, 1)
        exact = dict(wire.kinds)
        kv_len = cache.kv.k.shape[2] if cache.kv != () else 0
        _modelled_collectives(wire, cfg, rules, spec.kind, model.remat,
                              b_loc, seq, params, p_axes, p_axes, False,
                              cache_len=kv_len)
    modelled = {k: v - exact.get(k, 0) for k, v in wire.kinds.items()}

    def run(rows: Optional[int], counter):
        meta = _meta_model(model)
        if spec.kind == "prefill":
            b = batch if rows is None else {k: _shaped(v, rows)
                                            for k, v in batch.items()}
            return counter(lambda: meta.prefill(b, cache_len))
        if rows is None:
            c, t = cache, tok
        else:
            c, _ = shapes_lib.cache_specs(cfg, rows, _cache_length(cfg, spec))
            t = _shaped(tok, rows)
        return counter(lambda: meta.decode_step(c, t))

    return Lowered(
        math.prod(ms.values()),
        lambda: run(None, cost.flops_and_bytes),
        lambda: run(b_loc, cost.peak_live_bytes),
        memory, exact, modelled, wire.axes), rules


def _cache_length(cfg, spec) -> int:
    """The decode cache's length for a shape (the image prefix included,
    as ``launch.shapes.decode_input_specs`` builds it)."""
    return spec.seq + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
