"""The reference's dtype options in the port's ``build``: ``param_dtype``
and ``compute_dtype``, at ``cfg.reduced()`` from the reference's init
(carried across by ``convert.train_params_from_jax``, bf16 bits kept),
against the reference under ``jax.jit``.

* ``compute_dtype=None`` is ``compute_dtype=param_dtype``, bit for bit.
* A compute type narrower than the parameters' (bf16 over fp32) raises
  TypeError in both packages: the reference's layer scan takes its carry
  in bf16 and gets fp32 back.
* fp32 compute over bf16 parameters (bf16 storage, fp32 activations and
  products, as JAX's promotion gives): the loss within 1e-5 relative;
  each gradient coordinate, which both packages round from fp32 to bf16,
  within one bf16 ulp of its own magnitude (2^-7 |g|) per rounding, plus
  the fp32 limit (2e-5 of its leaf's max).  Most coordinates are rounded
  once; an embedding row sums each of its tokens' bf16 cotangents in
  bf16, and tied embeddings add the unembedding's, so up to BF16_ROUNDINGS
  = 4 roundings are allowed (2 are seen).  Control: the pure-bf16
  gradients fail it.
* bf16 parameters (the reference's bf16 training path, compute None):
  every activation is rounded to bf16 (8 bits) after each operation, at
  other points in the two packages (XLA fuses elementwise chains in fp32,
  ATen rounds after each).  The loss within 2^-8 relative (the reference's
  own bf16 loss lies up to 1e-3 from its fp32 loss on these models).  The
  gradient, taken as one vector over all leaves (the direction a step
  moves), within a relative L2 distance of 2^-4 for dense, VLM and RWKV
  models; 2^-2 for MoE, where a token whose k-th and (k+1)-th router
  probabilities lie within bf16 noise routes to another expert in one
  package, and that moves its whole contribution between two experts and
  the router (the reference's own bf16 gradient lies up to 0.16 from its
  fp32 one on these MoE models).  Every leaf keeps the reference's type:
  the router fp32, the rest bf16.  Control: the gradients with the
  labels shifted by one position must fail the limit.
* One Hier-AVG round of the reduced deepseek-v2-lite in bf16 (mean plan
  local@2/global@4, P = 4): the loss within 2^-8, every leaf's type the
  reference's (the fp32 router stays fp32 through the reducers' fp32
  deltas), and the round's update (new - old params, all leaves as one
  vector) within a relative L2 of 2^-1: a bf16 update is rounded to the
  parameter's ulp, so a step below half an ulp vanishes in one package
  and not the other.  Control: the reference's update on another batch
  must fail it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import HierAvgParams as JHier  # noqa: E402
from repro.core import hier_avg as jh  # noqa: E402
from repro.core.topology import HierTopology as JTopo  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import stubs as jstubs  # noqa: E402
from repro import optim as joptim  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.core import hier_avg as th  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

LOSS_REL, GRAD_REL = 1e-5, 2e-5
BF16_ULP, BF16_ROUNDINGS = 2.0 ** -7, 4
BF16_LOSS_REL = 2.0 ** -8
BF16_GRAD_L2 = {"moe": 2.0 ** -2}        # other families: 2^-4
BF16_UPDATE_L2 = 2.0 ** -1
ARCHS = {"rwkv6-1.6b": 48, "starcoder2-15b": 96, "deepseek-v2-lite-16b": 48,
         "phi3.5-moe-42b-a6.6b": 48, "qwen2-vl-2b": 48}


def _cfgs(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _batch(jcfg, lead, seq, seed):
    rng = np.random.default_rng(seed)
    nv = min(jcfg.frontend_tokens, seq // 4) if jcfg.family == "vlm" else 0
    toks = rng.integers(0, jcfg.vocab_size, size=lead + (seq - nv + 1,))
    toks = toks.astype(np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if nv:
        out["vision_embeds"] = (0.02 * rng.standard_normal(
            lead + (nv, jcfg.d_model))).astype(np.float32)
        pos = np.asarray(jstubs.mrope_positions(1, nv, seq - nv))[0]
        out["positions"] = np.array(np.broadcast_to(pos, lead + pos.shape))
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _rel_l2(a, b):
    """||a - b|| / ||b|| over all leaves as one vector."""
    a = np.concatenate([_f64(x).ravel() for x in a])
    b = np.concatenate([_f64(x).ravel() for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _dtypes(tree):
    return [str(x.dtype).replace("torch.", "") for x in leaves(tree)]


_INITS = {}


def _jax_params(arch, dtype):
    key = (arch, dtype)
    if key not in _INITS:
        jcfg, _ = _cfgs(arch)
        _INITS[key] = jax.tree.map(np.asarray, jax.jit(
            jbuild(jcfg, param_dtype=dtype).init)(jax.random.PRNGKey(0)))
    return _INITS[key]


def _jax_grads(arch, jp, batch, **opts):
    jcfg, _ = _cfgs(arch)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        jbuild(jcfg, **opts).loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), _jnp(batch))
    return float(jl), jax.tree.leaves(jg)


def _torch_grads(arch, jp, batch, **opts):
    _, cfg = _cfgs(arch)
    params = convert.train_params_from_jax(jp, cfg, device="cpu")
    tg, (tl, _) = torch.func.grad_and_value(
        build(cfg, device="cpu", **opts).loss_fn, has_aux=True)(
        params, _torch(batch))
    return float(tl), leaves(tg), tg


@pytest.fixture
def deterministic():
    """The CPU's threaded accumulation of the embedding's rows sums in
    another order from run to run; the deterministic mode pins it."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_compute_dtype_none_is_param_dtype(arch, deterministic):
    jcfg, cfg = _cfgs(arch)
    jp = _jax_params(arch, jnp.float32)
    batch = _batch(jcfg, (2,), ARCHS[arch], 1)
    _, a, _ = _torch_grads(arch, jp, batch)
    _, b, _ = _torch_grads(arch, jp, batch, compute_dtype=torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "starcoder2-15b",
                                  "deepseek-v2-lite-16b", "qwen2-vl-2b"])
def test_bf16_compute_over_fp32_params_raises_as_the_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp = _jax_params(arch, jnp.float32)
    batch = _batch(jcfg, (1,), ARCHS[arch], 1)
    with pytest.raises(TypeError):
        _jax_grads(arch, jp, batch, compute_dtype=jnp.bfloat16)
    bundle = build(cfg, compute_dtype=torch.bfloat16, device="cpu")
    params = bundle.init_train(torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="scan carry"):
        bundle.loss_fn(params, _torch(batch))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_fp32_compute_over_bf16_params_matches_jax(arch):
    jcfg, _ = _cfgs(arch)
    jp = _jax_params(arch, jnp.bfloat16)
    batch = _batch(jcfg, (2,), ARCHS[arch], 1)
    jl, jg = _jax_grads(arch, jp, batch, param_dtype=jnp.bfloat16,
                        compute_dtype=jnp.float32)
    tl, tg, tree = _torch_grads(arch, jp, batch, param_dtype=torch.bfloat16,
                                compute_dtype=torch.float32)
    assert abs(tl - jl) <= LOSS_REL * abs(jl)
    assert _dtypes(tree) == [x.dtype.name for x in jg]

    def within(a, b):
        a, b = _f64(a), _f64(b)
        return bool((np.abs(a - b) <= BF16_ROUNDINGS * BF16_ULP * np.abs(b)
                     + GRAD_REL * np.abs(b).max()).all())

    assert all(within(a, b) for a, b in zip(tg, jg))
    # control: the pure-bf16 gradients are further off than that
    _, cg, _ = _torch_grads(arch, jp, batch, param_dtype=torch.bfloat16)
    assert not all(within(a, b) for a, b in zip(cg, jg))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_params_match_jax(arch):
    jcfg, _ = _cfgs(arch)
    jp = _jax_params(arch, jnp.bfloat16)
    batch = _batch(jcfg, (2,), ARCHS[arch], 1)
    jl, jg = _jax_grads(arch, jp, batch, param_dtype=jnp.bfloat16)
    tl, tg, tree = _torch_grads(arch, jp, batch, param_dtype=torch.bfloat16)
    limit = BF16_GRAD_L2.get(jcfg.family, 2.0 ** -4)
    dist = _rel_l2(tg, jg)
    print(f"{arch} bf16: loss rel {abs(tl - jl) / abs(jl):.2e} (limit "
          f"{BF16_LOSS_REL:.2e}), gradient rel L2 {dist:.4f} (limit "
          f"{limit})")
    assert abs(tl - jl) <= BF16_LOSS_REL * abs(jl)
    assert _dtypes(tree) == [x.dtype.name for x in jg]
    if jcfg.uses_moe:
        assert tree["layers"]["ffn"]["router"].dtype == torch.float32
    assert dist <= limit
    # control: labels shifted by one position
    shifted = dict(batch, labels=np.roll(batch["labels"], 1, axis=-1))
    _, cg, _ = _torch_grads(arch, jp, shifted, param_dtype=torch.bfloat16)
    assert _rel_l2(cg, jg) > limit


def test_bf16_round_keeps_the_fp32_router_and_matches_jax():
    arch, seq, plan, shape = ("deepseek-v2-lite-16b", 32,
                              "local@2/global@4", (1, 2, 2))
    jcfg, cfg = _cfgs(arch)
    jp = _jax_params(arch, jnp.bfloat16)
    jhier, thier = JHier(plan=plan, bucket_bytes=0), \
        HierAvgParams(plan=plan, bucket_bytes=0)
    jstate = jh.init_state(JTopo(*shape), lambda k: jax.tree.map(
        jnp.asarray, jp), joptim.sgd(0.1), jax.random.PRNGKey(0), plan=plan,
        bucket_bytes=0)
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = convert.train_state_from_jax(np_state, device="cpu")
    lead = thier.batch_dims + shape + (2,)
    batch, other = (_batch(jcfg, lead, seq, s) for s in (2, 3))
    jround = jax.jit(jh.make_hier_round(
        jbuild(jcfg, param_dtype=jnp.bfloat16).loss_fn, joptim.sgd(0.1),
        jhier))
    jnew, jm = jround(jstate, _jnp(batch))
    jother, _ = jround(jstate, _jnp(other))
    tround = th.make_hier_round(
        build(cfg, param_dtype=torch.bfloat16, device="cpu").loss_fn,
        toptim.sgd(0.1), thier)
    tnew, tm = tround(tstate, _torch(batch))
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= BF16_LOSS_REL * abs(float(jm["loss"]))
    assert "aux_loss" in tm
    assert _dtypes(tnew.params) == [x.dtype.name for x in
                                    jax.tree.leaves(jnew.params)]
    assert tnew.params["layers"]["ffn"]["router"].dtype == torch.float32
    old = [_f64(x) for x in jax.tree.leaves(np_state.params)]

    def update(params):
        return [_f64(x) - o for x, o in zip(leaves(params), old)]

    want = update(jnew.params)
    dist = _rel_l2(update(tnew.params), want)
    ctrl = _rel_l2(update(jother.params), want)
    print(f"bf16 round update rel L2 {dist:.4f}, control {ctrl:.4f} "
          f"(limit {BF16_UPDATE_L2})")
    assert dist <= BF16_UPDATE_L2 < ctrl
