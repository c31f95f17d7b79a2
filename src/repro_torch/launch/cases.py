"""Dry-run cases (PyTorch port of ``repro/launch/cases.py``): an (arch x
input shape x mesh) case as meta structures, its placements and the step
a rank runs.

Nothing is allocated: the train state, the round batch and the serving
caches are built under one ``FakeTensorMode`` (the counterpart of the
reference's ``jax.eval_shape``) from the real init functions, the state
through ``core/hier_avg.py::init_state`` and the batch through
``models/stubs.py::train_batch_specs``.  A case carries two placements:

* ``reference_placement``: the bytes each of the reference's 256 (or 512)
  devices holds under the reference's rules (the port's copy of
  ``PartitionRules``, ``param_pspecs``, ``safe_pspec`` and the cache rules
  below, on ``make_hier_mesh`` / ``make_production_mesh``), summed from
  each argument's shard shape: the parity target;
* ``port_rank``: what one rank of the port holds when it runs the case.
  Training runs on ``rank_mesh(topo, fsdp, P * F)`` with ``model`` 1: a
  rank holds its learner's full parameters, and under fsdp its EF state
  is shard-aware (its shard's rows).  A serving case runs in one process
  on one card.

Two of the reference's state leaves differ in the port, and the
reference placement counts the reference's: ``TrainState.step`` (an
int32 scalar there, a host int here) and ``EFState.key`` (a uint32[2]
PRNG key there, the port's int64[3] carry on the host here).  The port's
host-side leaves are not device bytes of a rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (ArchConfig, HierAvgParams, InputShape,
                                      INPUT_SHAPES, ParallelLayout)
from repro_torch.core.topology import HierTopology
from repro_torch.launch.mesh import (PODS_MULTI, make_hier_mesh,
                                     make_production_mesh, rank_mesh)
from repro_torch.parallel.sharding import (P, PartitionRules, RankMesh,
                                           param_pspecs, safe_pspec,
                                           shard_plan)
from repro_torch.tree import flatten, leaf_paths, leaves, tree_map

# the reference's host-side stand-ins: (shape, dtype) of its scalar step
# and of its PRNG key
_REF_STEP = ((), torch.int32)
_REF_KEY = ((2,), torch.uint32)
# microbatches a traced train step runs (see train_case)
TRACE_MICROBATCHES = 2


@dataclasses.dataclass
class PortRank:
    """What one rank of the port holds and runs: ``args`` (fake tensors;
    leaves on the host are not counted), ``run(*args)`` one traced unit
    (an SGD step and one fire of each plan level, a decode step, or a
    prefill), ``mesh`` the rank's bound mesh (None: one process), and
    for training the rank's ``plan``, ``hier`` and ``block``."""

    args: Tuple
    run: Callable
    mesh: Optional[RankMesh] = None
    plan: Any = None
    hier: Optional[HierAvgParams] = None
    block: Optional[HierTopology] = None
    trace_note: str = ""
    traced_microbatches: int = 1


@dataclasses.dataclass
class DryrunCase:
    name: str
    cfg: ArchConfig
    shape: InputShape
    mesh: RankMesh              # the reference's mesh
    arg_specs: Tuple            # fake tensors, the reference's arguments
    arg_pspecs: Tuple           # PartitionSpecs under the reference's rules
    steps: int                  # SGD steps (or decode steps) per program
    port: PortRank
    fake_mode: Any
    notes: str = ""


# --------------------------------------------------------------------- #
# placements


def _ref_leaf(path: str, x) -> Optional[Tuple[Tuple[int, ...], Any]]:
    """(shape, dtype) of the reference's leaf that ``x`` at ``path``
    stands for, or None for a leaf the reference does not have."""
    name = path.split("/")[-1]
    if name == "key":
        return _REF_KEY
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if name == "step":
        return _REF_STEP
    return None


def shard_bytes(shape, dtype, spec, mesh: RankMesh) -> int:
    """Bytes of one device's shard of an array placed by ``spec``
    (``NamedSharding.shard_shape``): each dim divided by the product of
    its axes' mesh sizes."""
    n = 1
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, ax in zip(shape, spec):
        div = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                div *= mesh.shape[a]
        n *= dim // div
    return n * torch.empty((), dtype=dtype).element_size()


def reference_placement(case: DryrunCase) -> Dict:
    """The bytes each of the reference's devices holds (its arguments
    placed by the reference's rules), by argument and in all."""
    by_arg = []
    for tree, specs in zip(case.arg_specs, case.arg_pspecs):
        flat, _ = flatten(tree)
        sflat, _ = flatten(specs)
        total = 0
        for path, x, spec in zip(leaf_paths(tree), flat, sflat):
            ref = _ref_leaf(path, x)
            if ref is not None:
                total += shard_bytes(ref[0], ref[1], spec, case.mesh)
        by_arg.append(total)
    return {"mesh": dict(case.mesh.shape), "devices": case.mesh.size,
            "bytes_per_device": sum(by_arg), "by_arg": by_arg}


def param_tree(params):
    """A serving model's parameters as a tree of tensors: a module (the
    decoders' ``DecoderLM``) by its parameter names, "/"-joined as the
    rules match them; any other tree as it is."""
    if isinstance(params, torch.nn.Module):
        return {n.replace(".", "/"): p for n, p in params.named_parameters()}
    return params


def port_rank_bytes(case: DryrunCase) -> Dict:
    """The device bytes one rank of the port holds before it runs (its
    host-side leaves, the RNG carries and step counters, left out), by
    argument and in all."""
    by_arg = []
    for a in case.port.args:
        tree = param_tree(a)
        by_arg.append(sum(
            x.numel() * x.element_size()
            for path, x in zip(leaf_paths(tree), leaves(tree))
            if isinstance(x, torch.Tensor)
            and path.split("/")[-1] != "key"))
    mesh = case.port.mesh
    return {"mesh": None if mesh is None else dict(mesh.shape),
            "ranks": 1 if mesh is None else mesh.size,
            "bytes": sum(by_arg), "by_arg": by_arg}


# --------------------------------------------------------------------- #
# training case (hier mesh)

def parse_layout(spec: str) -> ParallelLayout:
    """'GxSxFxTP[:micro]' -> ParallelLayout (hillclimb override)."""
    micro = 1
    if ":" in spec:
        spec, m = spec.split(":")
        micro = int(m)
    g, s, f, tp = (int(x) for x in spec.split("x"))
    return ParallelLayout(groups=g, local=s, fsdp=f, tp=tp,
                          microbatch=micro)


def default_hier_params(cfg: ArchConfig) -> HierAvgParams:
    """Paper-faithful defaults: K1=4, K2=8 (beta=2) — small enough to keep
    the round compact, large enough that local+global reductions both
    appear in the collective schedule."""
    return HierAvgParams(k1=4, k2=8)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _comm_pspecs(comm_state, params, pspecs, mesh, shards):
    """The reference's specs of the per-level reducer state: EF ref/err
    (and PowerSGD's) that mirror the params reuse the params' specs;
    bucket-space leaves shard their learner axes (the codec view's merged
    dim over ("local", "fsdp")); PowerSGD's Q shards the learner axes
    only; the PRNG key stays replicated."""
    from repro_torch.comm.lowrank import LowRankState
    from repro_torch.comm.sparse import EFState
    p_shapes = [tuple(x.shape) for x in leaves(params)]
    s_sz = int(mesh.shape["local"])
    f_sz = int(mesh.shape.get("fsdp", 1))

    def lead_spec(leaf) -> P:
        lead = ("pod", "group", "local")
        if (shards is not None and leaf.dim() >= 3
                and leaf.shape[2] == s_sz * f_sz):
            lead = ("pod", "group", ("local", "fsdp"))
        return safe_pspec(P(*(lead + (None,) * (leaf.dim() - 3))),
                          tuple(leaf.shape), mesh, warn=False)

    def mirror(tree):
        if [tuple(x.shape) for x in leaves(tree)] == p_shapes:
            return _unflat_like(tree, pspecs)
        return tree_map(lead_spec, tree)

    def level(cs):
        if isinstance(cs, EFState):
            return EFState(ref=mirror(cs.ref), err=mirror(cs.err), key=P())
        if isinstance(cs, LowRankState):
            return LowRankState(ref=mirror(cs.ref), err=mirror(cs.err),
                                q=tree_map(lead_spec, cs.q))
        return tree_map(lambda _: P(), cs)

    if isinstance(comm_state, dict):
        return {k: level(v) for k, v in comm_state.items()}
    return level(comm_state)


def _unflat_like(tree, spec_tree):
    """``spec_tree``'s specs in ``tree``'s structure (the same leaves in
    the same order)."""
    from repro_torch.tree import unflatten
    _, treedef = flatten(tree)
    return unflatten(treedef, leaves(spec_tree))


def _state_pspecs(state, mesh, rules, shards):
    from repro_torch.core.hier_avg import TrainState
    pspecs = param_pspecs(state.params, mesh, stacked_learners=True,
                          rules=rules)
    opt = state.opt_state
    if leaves(opt):
        opt_specs = (_unflat_like(opt, pspecs)
                     if [tuple(x.shape) for x in leaves(opt)]
                     == [tuple(x.shape) for x in leaves(state.params)]
                     else tree_map(lambda x: safe_pspec(
                         P(*(("pod", "group", "local")
                             + (None,) * (x.dim() - 3))), tuple(x.shape),
                         mesh, warn=False), opt))
    else:
        opt_specs = opt
    comm = (_comm_pspecs(state.comm_state, state.params, pspecs, mesh,
                         shards) if state.comm_state else state.comm_state)
    return TrainState(pspecs, opt_specs, P(), comm)


def _train_unit(loss_fn, optimizer, hier, *, mesh=None, shards=None,
                microbatch=1):
    """One SGD step and one fire of each plan level: the round of
    ``hier`` run on a round batch whose step dims are all 1 (every level
    fires after the one step), a view of the whole round batch, which
    stays live as the real round's does; the step is a later step of
    the round (see ``run``), where the round's peak repeats."""
    from repro_torch.core.hier_avg import make_hier_round
    from repro_torch.parallel.sharding import make_constraint_fn
    rnd = make_hier_round(loss_fn, optimizer, hier, mesh=mesh,
                          constraint_fn=None if mesh is None
                          else make_constraint_fn(mesh),
                          microbatch=microbatch, shards=shards)
    nd = len(hier.batch_dims)
    later = hier.steps_per_round > 1

    def run(state, batch):
        one = tree_map(lambda x: x[(slice(0, 1),) * nd], batch)
        if later:
            # from a round's second step on, the caller's params (and
            # optimizer state) stay live beside the running ones: the
            # unit steps from a copy, as those steps do
            state = state._replace(
                params=tree_map(torch.clone, state.params),
                opt_state=tree_map(torch.clone, state.opt_state))
        return rnd(state, one)

    return run


def train_case(cfg: ArchConfig, shape: InputShape, *, multi_pod: bool,
               hier: Optional[HierAvgParams] = None,
               remat: bool = True, param_dtype=torch.bfloat16,
               impl: str = "auto",
               one_process: bool = False) -> DryrunCase:
    """The reference's train case.  ``one_process`` runs the port's side
    in one process (the whole grid on one card, as ``Simulator`` runs it)
    in place of one rank of ``rank_mesh``; ``impl`` "plain"
    traces the plain attention/WKV versions in place of the kernels'
    shape functions.  The traced step runs ``TRACE_MICROBATCHES`` of the
    layout's microbatches, each of its full size (the peak repeats from
    the second on)."""
    from repro_torch.core.hier_avg import init_state
    from repro_torch.core.plan import resolve_plan
    from repro_torch.models import build
    from repro_torch.models.stubs import train_batch_specs
    from repro_torch.optim import sgd

    hier = hier or default_hier_params(cfg)
    lay = cfg.layout
    mesh = make_hier_mesh(lay, multi_pod=multi_pod)
    pods = PODS_MULTI if multi_pod else 1
    topo = HierTopology(pods=pods, groups=lay.groups, local=lay.local)
    rules = PartitionRules()
    shards = shard_plan(mesh, rules=rules) if lay.fsdp > 1 else None
    bundle = build(cfg, param_dtype=param_dtype, remat=remat, impl=impl,
                   device="cpu")
    optimizer = sgd(0.1)          # paper: plain SGD, step-decayed lr
    per_learner_b = shape.global_batch // topo.n_learners
    assert per_learner_b >= 1, (cfg.name, shape.name, topo)

    fake = _fake_mode()
    gen = torch.Generator().manual_seed(0)
    with fake:
        plan = resolve_plan(hier, None, None, shards=shards)
        state = init_state(topo, bundle.init_train, optimizer, gen,
                           plan=plan, shards=shards, device="cpu")
        inner = train_batch_specs(cfg, per_learner_b, shape.seq_len,
                                  dtype=param_dtype)
        lead = hier.batch_dims + topo.shape
        batch = {k: torch.empty(lead + tuple(v.shape), dtype=v.dtype)
                 for k, v in inner.items()}
    from repro_torch.data.loader import round_batch_shardings
    batch_specs = tree_map(lambda s: s.spec,
                           round_batch_shardings(mesh, hier, batch))
    state_specs = _state_pspecs(state, mesh, rules, shards)

    # one rank of the port: rank_mesh(topo, fsdp, P*F), rank 0's block
    micro = lay.microbatch
    world = topo.n_learners * lay.fsdp
    rmesh = None if one_process else rank_mesh(topo, lay.fsdp, world, 0)
    if rmesh is not None and rmesh.size == 1:
        rmesh = None
    rshards = (shard_plan(rmesh) if rmesh is not None and lay.fsdp > 1
               else None)
    block = rmesh.block_topology(topo) if rmesh is not None else topo
    mb_b = per_learner_b // micro if per_learner_b % micro == 0 else None
    if mb_b is None:
        micro, mb_b = 1, per_learner_b
    traced_mb = min(micro, TRACE_MICROBATCHES)
    with fake:
        rplan = resolve_plan(hier, None, None, shards=rshards)
        rstate = init_state(block, bundle.init_train, optimizer, gen,
                            plan=rplan, shards=rshards, device="cpu")
        rlead = hier.batch_dims + block.shape
        rbatch = {k: torch.empty(rlead + (mb_b * traced_mb,)
                                 + tuple(v.shape[1:]), dtype=v.dtype)
                  for k, v in inner.items()}
    run = _train_unit(bundle.loss_fn, optimizer, hier, mesh=rmesh,
                      shards=rshards, microbatch=traced_mb)
    port = PortRank(args=(rstate, rbatch), run=run, mesh=rmesh, plan=rplan,
                    hier=hier, block=block,
                    trace_note=f"{traced_mb} of {micro} microbatch(es) "
                               f"of {mb_b}",
                    traced_microbatches=traced_mb)
    return DryrunCase(
        name=f"{cfg.name}:{shape.name}:{'2pod' if multi_pod else '1pod'}",
        cfg=cfg, shape=shape, mesh=mesh, arg_specs=(state, batch),
        arg_pspecs=(state_specs, batch_specs), steps=hier.steps_per_round,
        port=port, fake_mode=fake,
        notes=f"hier_round plan={plan.describe()} "
              f"{topo.describe()} fsdp={lay.fsdp} tp={lay.tp} "
              f"B/learner={per_learner_b}")


# --------------------------------------------------------------------- #
# serving cases (production mesh)

_SERVE_AXIS_MAP_1POD = {"pod": None, "group": None, "local": None,
                        "fsdp": "data", "model": "model"}


def _serve_param_pspecs(params, mesh: RankMesh, multi_pod: bool):
    amap = dict(_SERVE_AXIS_MAP_1POD)
    if multi_pod:
        amap["fsdp"] = ("pod", "data")
    rules = PartitionRules(axis_map=amap)
    return param_pspecs(params, mesh, stacked_learners=False, rules=rules)


def _batch_axis(mesh: RankMesh, multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def _cache_pspec(path: str, shape: Tuple[int, ...], mesh: RankMesh,
                 batch: int, multi_pod: bool) -> P:
    """The reference's cache sharding of a layer-stacked leaf [L, B, ...]:
    batch dim over data (when divisible), heads/state over model, and for
    batch-1 long-context the sequence dim over data."""
    bax = _batch_axis(mesh, multi_pod)
    ndim = len(shape)
    if ndim == 0:          # pos counters
        return P()
    if ndim == 1:          # stacked pos [L]
        return P(None)
    spec = [None] * ndim
    spec[1] = bax
    name = path.split("/")[-1]
    tp = mesh.shape["model"]
    if name in ("k", "v", "cross_k", "cross_v") and ndim >= 5:
        if shape[3] % tp == 0:
            spec[3] = "model"
        elif shape[4] % tp == 0:
            spec[4] = "model"
        elif shape[2] % tp == 0:
            spec[2] = "model"
        if batch == 1:
            spec[1] = None
            spec[2] = bax if shape[2] % 16 == 0 else None
    elif name in ("ckv", "k_rope") and ndim >= 4:
        if shape[3] % tp == 0:
            spec[3] = "model"
        if batch == 1:
            spec[1] = None
            spec[2] = bax if shape[2] % 16 == 0 else None
    elif name == "wkv" and ndim >= 3:
        spec[2] = "model"
    elif name in ("ssm", "conv") and ndim >= 3:
        spec[2] = "model" if name == "ssm" else None
        if name == "conv" and ndim >= 4:
            spec[3] = "model"
    elif name in ("tm_shift", "cm_shift") and ndim >= 3:
        spec[2] = "model"
    return safe_pspec(P(*spec), shape, mesh, warn=False)


def layer_stacked(tree) -> Dict[str, torch.Tensor]:
    """The reference's view of a per-layer tree (the port keeps a serving
    model's layers and caches as lists; the reference stacks them): each
    leaf under the first list index of its path joins its siblings of the
    other layers as one meta tensor ``[L, *shape]`` at the path without
    the index; a layer's position counter (a host int) is the
    reference's int32 ``[L]``.  Other leaves stay as they are."""
    groups: Dict[str, List] = {}
    for path, x in zip(leaf_paths(tree), leaves(tree)):
        parts = path.split("/")
        idx = next((i for i, p in enumerate(parts) if p.isdigit()), None)
        key = path if idx is None else "/".join(parts[:idx] + parts[idx + 1:])
        groups.setdefault(key, []).append((idx is not None, x))
    out = {}
    for key, xs in groups.items():
        stacked, x = xs[0]
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) else ()
        dtype = x.dtype if isinstance(x, torch.Tensor) else torch.int32
        out[key] = torch.empty(((len(xs),) if stacked else ()) + shape,
                               dtype=dtype, device="meta")
    return out


def _serve_bundle(cfg, shape, *, param_dtype, cache_dtype, remat):
    from repro_torch.models import build
    rolling = (shape.name == "long_500k"
               and cfg.family in ("dense", "moe", "vlm", "audio")
               and not cfg.kv_lora_rank)
    return build(cfg, param_dtype=param_dtype, cache_dtype=cache_dtype,
                 remat=remat, rolling_decode=rolling, device="cpu"), rolling


def decode_case(cfg: ArchConfig, shape: InputShape, *, multi_pod: bool,
                param_dtype=torch.bfloat16,
                cache_dtype=torch.bfloat16) -> DryrunCase:
    mesh = make_production_mesh(multi_pod=multi_pod)
    bundle, rolling = _serve_bundle(cfg, shape, param_dtype=param_dtype,
                                    cache_dtype=cache_dtype, remat=False)
    B = shape.global_batch
    max_len = shape.seq_len
    fake = _fake_mode()
    with fake:
        params = bundle.init(torch.Generator().manual_seed(0))
        cache = bundle.init_cache(B, max_len)
        tokens = torch.empty((B,), dtype=torch.int32)
    ptree = layer_stacked(param_tree(params))
    p_specs = _serve_param_pspecs(ptree, mesh, multi_pod)
    bax = _batch_axis(mesh, multi_pod)
    tok_spec = safe_pspec(P(bax), (B,), mesh, warn=False)
    ctree = layer_stacked(cache)
    c_specs = {p: _cache_pspec(p, tuple(x.shape), mesh, B, multi_pod)
               for p, x in ctree.items()}
    kind = ("rolling-window" if rolling else
            "mla-latent" if cfg.kv_lora_rank else
            "state" if cfg.family in ("ssm", "hybrid") else "full-kv")

    def run(params, tokens, cache):
        return bundle.decode_step(params, tokens, cache)

    return DryrunCase(
        name=f"{cfg.name}:{shape.name}:{'2pod' if multi_pod else '1pod'}",
        cfg=cfg, shape=shape, mesh=mesh,
        arg_specs=(ptree, tokens, ctree),
        arg_pspecs=(p_specs, tok_spec, c_specs),
        steps=1, port=PortRank(args=(params, tokens, cache), run=run),
        fake_mode=fake, notes=f"serve_step cache={kind} B={B} "
                              f"ctx={max_len}")


def prefill_case(cfg: ArchConfig, shape: InputShape, *, multi_pod: bool,
                 param_dtype=torch.bfloat16,
                 remat: bool = True) -> DryrunCase:
    from repro_torch.models.stubs import train_batch_specs
    mesh = make_production_mesh(multi_pod=multi_pod)
    bundle, _ = _serve_bundle(cfg, shape, param_dtype=param_dtype,
                              cache_dtype=torch.bfloat16, remat=remat)
    B = shape.global_batch
    fake = _fake_mode()
    with fake:
        params = bundle.init(torch.Generator().manual_seed(0))
        inner = train_batch_specs(cfg, B, shape.seq_len, dtype=param_dtype)
        inner.pop("labels", None)
        batch = {k: torch.empty(tuple(v.shape), dtype=v.dtype)
                 for k, v in inner.items()}
    ptree = layer_stacked(param_tree(params))
    p_specs = _serve_param_pspecs(ptree, mesh, multi_pod)
    bax = _batch_axis(mesh, multi_pod)
    b_specs = {k: safe_pspec(P(*((bax,) + (None,) * (v.dim() - 1))),
                             tuple(v.shape), mesh, warn=False)
               for k, v in batch.items()}

    def run(params, batch):
        logits, _cache = bundle.prefill(params, batch)
        return logits

    return DryrunCase(
        name=f"{cfg.name}:{shape.name}:{'2pod' if multi_pod else '1pod'}",
        cfg=cfg, shape=shape, mesh=mesh, arg_specs=(ptree, batch),
        arg_pspecs=(p_specs, b_specs), steps=1,
        port=PortRank(args=(params, batch), run=run), fake_mode=fake,
        notes=f"prefill B={B} S={shape.seq_len}")


def build_case(cfg: ArchConfig, shape_name: str, *, multi_pod: bool,
               **kw) -> DryrunCase:
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return train_case(cfg, shape, multi_pod=multi_pod, **kw)
    if shape.kind == "prefill":
        return prefill_case(cfg, shape, multi_pod=multi_pod)
    return decode_case(cfg, shape, multi_pod=multi_pod)
