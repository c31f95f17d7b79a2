"""The port's MoE layer, MLA attention, M-RoPE and the VLM stub against the
JAX package's, on the reference's weights (carried across as numpy) and
numpy inputs; reference outputs under ``jax.jit``.

Tolerances, fp32: outputs within 1e-5 of their largest magnitude (XLA and
ATen sum products in other orders), the aux loss within 1e-6 relative,
integer positions and the M-RoPE channel selection exactly.

Routing: ``torch.topk`` and ``jax.lax.top_k`` order exact ties alike (the
lower index first), but the two packages' fp32 router probabilities may
differ in the last bits, and a token whose k-th and (k+1)-th experts lie
closer than that can take either.  Gate indices must be equal except on
tokens whose reference probabilities at ranks k and k + 1 lie within
NOISE times the largest difference of the two packages' probabilities;
each test prints its nearest margin.  A flip there also moves which
tokens a full expert drops, so outputs and the aux loss are held only
when no token flipped (none does at these seeds: the printed margins lie
far above the noise).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import stubs as jstubs  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.convert import tree_from_numpy  # noqa: E402
from repro_torch.core.hier_avg import stacked_grad_fn  # noqa: E402
from repro_torch.core.topology import HierTopology  # noqa: E402
from repro_torch.comm.sparse import stream_seed  # noqa: E402
from repro_torch.data.loader import HierDataLoader  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import stubs  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

REL, AUX_REL, NOISE = 1e-5, 1e-6, 10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_rel(a, b, rel, what=""):
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0.0,
                               atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _moe_pair(seed, d, eff, e, shared, act="silu"):
    jp = _np(jmoe.moe_init(jax.random.PRNGKey(seed), d, eff, e, shared, act))
    return jp, tree_from_numpy(jp, device="cpu")


def _gate_flips(jp, tp, x, top_k):
    """(tokens whose gate sets differ, the nearest reference margin)
    after checking that each flip is a near-tie."""
    jprobs = np.asarray(jax.jit(lambda r, x: jax.nn.softmax(
        x @ r, axis=-1))(jnp.asarray(jp["router"]), jnp.asarray(x)))
    jidx = np.asarray(jax.lax.top_k(jnp.asarray(jprobs), top_k)[1])
    valid = torch.ones(x.shape[1])
    tprobs, _, tidx = moe._gates(tp["router"], torch.from_numpy(x), valid,
                                 top_k)
    tprobs, tidx = tprobs.numpy(), tidx.numpy()
    noise = NOISE * max(np.abs(tprobs - jprobs).max(), 1e-12)
    ranked = -np.sort(-jprobs, axis=-1)
    margin = ranked[..., top_k - 1] - ranked[..., top_k]
    flips = (np.sort(tidx, -1) != np.sort(jidx, -1)).any(-1)
    assert (margin[flips] <= noise).all(), (margin[flips], noise)
    # where no flip, the order by falling probability is the reference's
    # except between experts tied within the noise
    same = ~flips
    order_ok = (tidx == jidx).all(-1) | (np.abs(
        np.diff(ranked[..., :top_k], axis=-1)) <= noise).any(-1)
    assert order_ok[same].all()
    print(f"nearest k/k+1 margin {margin.min():.3e}, noise {noise:.3e}, "
          f"{int(flips.sum())} flips")
    return int(flips.sum())


@pytest.mark.parametrize("case", [
    # (cf, chunk, seq, top_k, experts, shared, act)
    ("dropless", 2.0, 4096, 48, 2, 4, 1, "silu"),
    ("drops", 1.25, 4096, 48, 2, 4, 1, "silu"),
    ("drops chunked padded", 1.25, 16, 40, 2, 4, 0, "silu"),
    ("dropless chunked", 2.0, 16, 48, 2, 4, 1, "gelu"),
    ("top-6 of 8, drops", 1.0, 4096, 32, 6, 8, 2, "silu"),
], ids=lambda c: c[0])
def test_moe_apply_matches_jax(case):
    _, cf, chunk, seq, k, e, shared, act = case
    d, eff = 32, 48
    jp, tp = _moe_pair(3, d, eff, e, shared, act)
    x = np.random.default_rng(4).standard_normal((2, seq, d)).astype(
        np.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, act=act,
              chunk=chunk)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, **kw))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    ty, taux = moe.moe_apply(tp, torch.from_numpy(x), **kw)
    assert ty.shape == x.shape and taux.dtype == torch.float32
    flips = _gate_flips(jp, tp, x, k)
    if not flips:
        _close_rel(taux, jaux, AUX_REL, "aux")
        _close_rel(ty, jy, REL, "y")
    if cf < e / k:
        # tokens routed past a full expert are dropped: the output differs
        # from the dropless one
        full, _ = moe.moe_apply(tp, torch.from_numpy(x),
                                **dict(kw, capacity_factor=e / k))
        assert not torch.allclose(ty, full)


def test_moe_gradients_match_jax():
    """d(sum(y * w) + aux)/d(params, x) through the dispatch, the expert
    FFN, the combine and the router (fp32), at capacity 1.25 with
    drops."""
    d, eff, e, k = 32, 48, 4, 2
    jp, tp = _moe_pair(5, d, eff, e, 1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 40, d)).astype(np.float32)
    w = rng.standard_normal((2, 40, d)).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=1.25, chunk=16)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, **kw)
        return (y * w).sum() + aux

    def tloss(p, x):
        y, aux = moe.moe_apply(p, x, **kw)
        return (y * torch.from_numpy(w)).sum() + aux

    assert _gate_flips(jp, tp, x, k) == 0
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tg = torch.func.grad(tloss, argnums=(0, 1))(tp, torch.from_numpy(x))
    jl, tl = jax.tree.leaves(jg), leaves(tg)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        _close_rel(a, b, 2e-5)


# -- the reference's own MoE properties (tests/test_models_extra.py), on
#    the port

def test_moe_chunk_invariance_dropless():
    _, p = _moe_pair(0, 32, 64, 4, 1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 32)).astype(np.float32))
    cf = 4.0 / 2
    y1, _ = moe.moe_apply(p, x, n_experts=4, top_k=2, capacity_factor=cf,
                          chunk=16)
    y2, _ = moe.moe_apply(p, x, n_experts=4, top_k=2, capacity_factor=cf,
                          chunk=64)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)


def test_moe_aux_loss_uniform_router_is_one():
    _, p = _moe_pair(2, 16, 32, 4, 0)
    p = dict(p, router=torch.zeros((16, 4)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 64, 16)).astype(np.float32))
    _, aux = moe.moe_apply(p, x, n_experts=4, top_k=2, capacity_factor=2.0)
    np.testing.assert_allclose(float(aux), 1.0, atol=0.3)


def test_moe_drops_tokens_at_low_capacity():
    _, p = _moe_pair(4, 16, 32, 2, 0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 32, 16)).astype(np.float32))
    y_full, _ = moe.moe_apply(p, x, n_experts=2, top_k=1,
                              capacity_factor=2.0)
    y_tiny, _ = moe.moe_apply(p, x, n_experts=2, top_k=1,
                              capacity_factor=0.1)
    assert not np.allclose(y_full.numpy(), y_tiny.numpy())
    assert float(y_tiny.abs().sum()) < float(y_full.abs().sum())
    # a dropped token's routed output is exactly zero
    assert int((y_tiny.abs().sum(-1) == 0).sum()) >= 32 - 2 * 2


def test_moe_leaves_keep_an_fp32_router_in_bf16():
    p = moe.moe_params(16, 32, 4, 1, "silu", torch.bfloat16, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert p["router"].dtype == torch.float32
    assert {t.dtype for t in leaves(p["experts"])} == {torch.bfloat16}
    assert p["experts"]["w_up"].shape == (4, 16, 32)
    assert p["shared"]["w_up"].shape == (16, 32)


# -- MLA, M-RoPE and the VLM stub

@pytest.mark.parametrize("seq", [48, 4096])
def test_mla_attention_matches_jax(seq):
    """At 4096 tokens both attend in query chunks of 1024."""
    d, h, lora, nope, rope, v = 32, 2, 16, 16, 8, 16
    jp = _np(jattn.mla_init(jax.random.PRNGKey(7), d, h, lora, nope, rope,
                            v))
    tp = tree_from_numpy(jp, device="cpu")
    assert jattn._pick_q_chunk(seq) == tattn._pick_q_chunk(seq)
    x = (np.random.default_rng(8).standard_normal((1, seq, d)) * 0.5
         ).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (1, seq))
    kw = dict(n_heads=h, kv_lora=lora, qk_nope=nope, qk_rope=rope, v_dim=v)

    def jrun(p, x):
        cos, sin = jcommon.rope_cos_sin(jnp.asarray(pos), rope, 1e4)
        return jattn.mla_attention(p, x, cos, sin, **kw)

    want = jax.jit(jrun)(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    cos, sin = common.rope_cos_sin(torch.from_numpy(pos.copy()), rope, 1e4)
    got = tattn.mla_attention(tp, torch.from_numpy(x), cos, sin, **kw)
    _close_rel(got, want, REL, "mla")


def test_mrope_cos_sin_matches_jax():
    rng = np.random.default_rng(9)
    pos = rng.integers(0, 300, size=(2, 7, 3)).astype(np.int32)
    sections = (4, 6, 6)
    jcos, jsin = jcommon.mrope_cos_sin(jnp.asarray(pos), 32, 1e6, sections)
    cos, sin = common.mrope_cos_sin(torch.from_numpy(pos), 32, 1e6,
                                    sections)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)
    # each section is plain RoPE of its own coordinate, bit for bit
    lo = 0
    for coord, n in enumerate(sections):
        c, s = common.rope_cos_sin(torch.from_numpy(pos[..., coord]), 32,
                                   1e6)
        assert torch.equal(cos[..., lo:lo + n], c[..., lo:lo + n])
        assert torch.equal(sin[..., lo:lo + n], s[..., lo:lo + n])
        lo += n


@pytest.mark.parametrize("nv,st,grid", [(16, 5, None), (256, 9, None),
                                        (12, 3, None), (24, 4, (2, 3, 4))])
def test_mrope_positions_match_jax(nv, st, grid):
    want = np.asarray(jstubs.mrope_positions(3, nv, st, grid))
    got = stubs.mrope_positions(3, nv, st, grid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_vlm_batch_reaches_each_learner_intact():
    """The VLM stub's keys go through the round loader (stacked and
    reshaped per learner) and into each learner's loss_fn unchanged: the
    per-learner metrics read back each learner's vision embeddings and
    M-RoPE positions."""
    cfg = get_config("qwen2-vl-2b").reduced()
    topo, hier = HierTopology(1, 2, 2), HierAvgParams(k1=2, k2=4)
    b, seq = 2, 32

    def sample(gen, n):
        return stubs.make_train_batch(gen, cfg, batch=n, seq_len=seq)

    one = sample(torch.Generator().manual_seed(0), b)
    nv = min(cfg.frontend_tokens, seq // 4)
    assert one["vision_embeds"].shape == (b, nv, cfg.d_model)
    assert one["positions"].shape == (b, seq, 3)
    assert one["tokens"].shape == one["labels"].shape == (b, seq - nv)
    loader = HierDataLoader(sample, topo=topo, hier=hier,
                            per_learner_batch=b, seed=3, device="cpu")
    rb = loader.next_round()
    lead = hier.batch_dims + topo.shape
    assert rb["positions"].shape == lead + (b, seq, 3)
    assert rb["vision_embeds"].shape == lead + (b, nv, cfg.d_model)
    # cell (step, learner) is the stub's draw from its own stream
    flat = {k: v.reshape((-1,) + tuple(v.shape[len(lead):]))
            for k, v in rb.items()}
    cell = 5
    want = sample(torch.Generator().manual_seed(stream_seed(3, 0, cell)), b)
    for key in want:
        assert torch.equal(flat[key][cell], want[key]), key

    bundle = build(cfg, device="cpu")

    def loss_fn(params, batch):
        loss, m = bundle.loss_fn(params, batch)
        m["vision_sum"] = batch["vision_embeds"].double().sum()
        m["positions_sum"] = batch["positions"].double().sum()
        m["text_len"] = torch.tensor(float(batch["tokens"].shape[-1]))
        return loss, m

    params = bundle.init_train(torch.Generator().manual_seed(0))
    stacked = tree_map(lambda a: a.expand(lead[len(hier.batch_dims):]
                                          + tuple(a.shape)).clone(), params)
    step = {k: v[(0,) * len(hier.batch_dims)] for k, v in rb.items()}
    _, m = stacked_grad_fn(loss_fn)(stacked, step)
    for key, name in (("vision_embeds", "vision_sum"),
                      ("positions", "positions_sum")):
        want = step[key].double().sum(dim=tuple(range(3, step[key].dim())))
        assert torch.equal(m[name], want), key
    assert (m["text_len"] == seq - nv).all()
    assert torch.isfinite(m["loss"]).all()


def test_make_train_batch_takes_audio_too():
    """The family dispatch: the VLM's batch carries patch embeddings and
    positions, the encoder-decoder's stub frames (the reference's
    ``max(4, seq // 4)`` of them, capped at ``frontend_tokens``)."""
    gen = torch.Generator().manual_seed(0)
    cfg = get_config("seamless-m4t-large-v2")
    for seq, tf in ((8, 4), (64, 16), (8192, 1024)):
        b = stubs.make_train_batch(gen, cfg, 1, seq)
        assert sorted(b) == ["frames", "labels", "tokens"]
        assert b["frames"].shape == (1, tf, cfg.d_model)
    b = stubs.make_train_batch(gen, get_config("qwen2-vl-2b").reduced(), 1,
                               32)
    assert sorted(b) == ["labels", "positions", "tokens", "vision_embeds"]
