"""The port's LM training stack against the JAX package's: the RWKV-6 LM,
the dense GQA decoders (starcoder2's window cut to 64, at a sequence of
128 so that it bites), the MoE/MLA decoders (deepseek-v2-lite with its
dense first layer, phi3.5-moe) and the M-RoPE VLM backbone (qwen2-vl,
with the stub's patch embeddings in front of the text) at
``cfg.reduced()``, the Markov data, the round loader and the training
CLI.

Both packages start from the reference's init, carried across as numpy by
``convert.train_params_from_jax``, and take the same numpy batches;
reference outputs come from ``jax.jit``.  The port runs on the CPU, where
attention and the WKV recurrence take their plain versions through the
kernels' autograd Functions and vmap rules.

Tolerances, fp32: losses within 1e-5 relative; each gradient leaf within
2e-5 of its largest magnitude (a 2-layer model whose attention and WKV
backward are explicit formulas against autodiff, summed in another order);
after one Hier-AVG round, params and EF state within 1e-5 relative plus
1e-6 absolute, as tests/test_torch_hier.py holds the trainer.  Top-k
selections: the reduced LM's leaves hold up to 262,144 coordinates per
learner, whose magnitudes near the k-th lie some 1e-8 apart, less than
the 3e-8 to 7e-8 by which the two packages' fp32 deltas differ; so a
fire's support must equal the reference's except for swaps of
coordinates whose magnitudes both lie within 10x that difference of the
k-th (near-ties that fp32 cannot order), at most one per thousand of k,
and most leaves must select exactly the same indices.  A wrong index
lands far from the k-th magnitude and fails.
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
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import stubs as jstubs  # noqa: E402
from repro import optim as joptim  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.comm import sparse as tsparse  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.core import hier_avg as th  # noqa: E402
from repro_torch.core.topology import HierTopology  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.loader import HierDataLoader  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.stubs import make_train_batch  # noqa: E402
from repro_torch.models.transformer import _split_layers  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

LOSS_REL, GRAD_REL, RTOL, ATOL = 1e-5, 2e-5, 1e-5, 1e-6
NOISE = 10          # a swap's magnitudes tie within NOISE x the delta diff
ARCHS = {"rwkv6-1.6b": 64, "starcoder2-15b": 128,     # arch -> sequence
         "deepseek-v2-lite-16b": 64, "phi3.5-moe-42b-a6.6b": 64,
         "qwen2-vl-2b": 64, "yi-34b": 64, "deepseek-67b": 64,
         "mistral-large-123b": 64}


def _cfgs(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    """Leaf paths in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [prefix]


_INITS = {}


def _jax_params(arch):
    if arch not in _INITS:
        jcfg, _ = _cfgs(arch)
        _INITS[arch] = _np(jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0)))
    return _INITS[arch]


def _tokens(rng, shape, vocab):
    toks = rng.integers(0, vocab, size=shape[:-1] + (shape[-1] + 1,))
    toks = toks.astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _batch(rng, jcfg, shape):
    """Tokens and labels of ``shape`` [..., seq]; for the VLM, the stub's
    patch embeddings (0.02 x normal) and M-RoPE positions in front of
    seq - Nv text tokens."""
    nv = min(jcfg.frontend_tokens, shape[-1] // 4) \
        if jcfg.family == "vlm" else 0
    out = _tokens(rng, shape[:-1] + (shape[-1] - nv,), jcfg.vocab_size)
    if nv:
        out["vision_embeds"] = (0.02 * rng.standard_normal(
            shape[:-1] + (nv, jcfg.d_model))).astype(np.float32)
        pos = np.asarray(jstubs.mrope_positions(1, nv, shape[-1] - nv))[0]
        out["positions"] = np.array(np.broadcast_to(pos, shape[:-1]
                                                    + pos.shape))
    return out


def _close_rel(a, b, rel, what=""):
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0.0,
                               atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def test_reduced_windows_bite():
    _, cfg = _cfgs("starcoder2-15b")
    assert 0 < cfg.sliding_window < ARCHS["starcoder2-15b"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_training_leaves_match_the_reference(arch):
    """Paths, shapes, types and order of the training tree equal
    ``jax.tree.leaves`` of the reference's init, from the port's own init
    and through ``convert``."""
    jcfg, cfg = _cfgs(arch)
    jp = _jax_params(arch)
    want = [(p, a.shape, a.dtype.name) for p, a in zip(
        _paths(jp), jax.tree.leaves(jp))]
    bundle = build(cfg, device="cpu")
    for tree in (bundle.init_train(torch.Generator().manual_seed(0)),
                 convert.train_params_from_jax(jp, cfg, device="cpu")):
        got = [(p, tuple(a.shape), str(a.dtype).replace("torch.", ""))
               for p, a in zip(_paths(tree), leaves(tree))]
        assert got == want
    n_pre, n_main = _split_layers(cfg) if cfg.family != "ssm" else (0, 2)
    assert cfg.n_layers == n_pre + n_main == 2 and all(
        a.shape[0] == n_main for a in leaves(jp["layers"]))
    assert all(a.shape[0] == n_pre
               for a in leaves(jp.get("layers_dense", {})))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_gradients_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp = _jax_params(arch)
    batch = _batch(np.random.default_rng(1), jcfg, (2, ARCHS[arch]))
    jb = jbuild(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    bundle = build(cfg, device="cpu")
    params = convert.train_params_from_jax(jp, cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tg, (tl, tm) = torch.func.grad_and_value(bundle.loss_fn, has_aux=True)(
        params, tb)
    _close_rel(tl, jl, LOSS_REL, "loss")
    _close_rel(tm["accuracy"], jm["accuracy"], LOSS_REL, "accuracy")
    assert sorted(tm) == sorted(jm)
    if cfg.uses_moe:
        _close_rel(tm["aux_loss"], jm["aux_loss"], LOSS_REL, "aux_loss")
    for path, a, b in zip(_paths(jp), leaves(tg), jax.tree.leaves(jg)):
        _close_rel(a, b, GRAD_REL, f"grad {path}")


def _record_fires(monkeypatch):
    fires = []
    real = tsparse.ops.topk_compress

    def recording(x, k, **kw):
        out = real(x, k, **kw)
        fires.append((x.detach().clone(), k, out[1].clone()))
        return out

    monkeypatch.setattr(tsparse.ops, "topk_compress", recording)
    return fires


def test_hier_round_with_topk_matches_jax(monkeypatch):
    """One round of the reduced RWKV-6 LM, plan local@2/global@4:topk:0.1
    per leaf, P = 4 as (1, 2, 2), from one converted state on one numpy
    round batch.  The loss agrees; each fire's support agrees with the
    reference's (the zeros of its EF residual) except where two
    coordinates' magnitudes tie to within the packages' fp32 difference
    in the delta (NOISE times the largest difference of the unsent
    residual): those may swap, and nothing else; params agree off the
    swapped coordinates and by at most a sent delta on them."""
    _topk_round(monkeypatch, "rwkv6-1.6b", 16)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b"])
def test_hier_round_with_topk_matches_jax_moe_mla_vlm(monkeypatch, arch):
    """The round of test_hier_round_with_topk_matches_jax on the MoE, MLA
    and VLM decoders, under the same limits; the stacked expert leaves
    and the fp32 router go through the per-leaf top-k like any other."""
    _topk_round(monkeypatch, arch, 32)


def _topk_round(monkeypatch, arch, seq):
    plan = "local@2/global@4:topk:0.1"
    jcfg, cfg = _cfgs(arch)
    fires = _record_fires(monkeypatch)
    shape = (1, 2, 2)
    jhier, thier = JHier(plan=plan, bucket_bytes=0), \
        HierAvgParams(plan=plan, bucket_bytes=0)
    jp = _jax_params(arch)
    jstate = jh.init_state(JTopo(*shape), lambda k: jax.tree.map(
        jnp.asarray, jp), joptim.sgd(0.1), jax.random.PRNGKey(0), plan=plan,
        bucket_bytes=0)
    tstate = convert.train_state_from_jax(_np(jstate), device="cpu")
    batch = _batch(np.random.default_rng(2), jcfg,
                   thier.batch_dims + shape + (2, seq))
    jround = jax.jit(jh.make_hier_round(jbuild(jcfg).loss_fn,
                                        joptim.sgd(0.1), jhier))
    jstate, jm = jround(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tround = th.make_hier_round(build(cfg, device="cpu").loss_fn,
                                toptim.sgd(0.1), thier)
    tstate, tm = tround(tstate, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    _close_rel(tm["loss"], jm["loss"], LOSS_REL, "loss")
    assert len(fires) == len(leaves(tstate.params))     # one global fire
    exact = swaps = 0
    for (delta, k, idx), ta, ja, tp, jpar, path in zip(
            fires, leaves(tstate.comm_state["global"].err),
            jax.tree.leaves(jstate.comm_state["global"].err),
            leaves(tstate.params), jax.tree.leaves(jstate.params),
            _paths(jp)):
        a = ta.numpy().reshape(delta.shape)
        b = np.asarray(ja).reshape(delta.shape)
        mags = delta.abs().numpy()
        sent = np.zeros(delta.shape, bool)
        np.put_along_axis(sent, idx.long().numpy(), True, axis=1)
        # the residual is the delta off the support, 0 on it (a delta of
        # exactly 0, as on the rows of tokens no learner saw, sends nothing)
        np.testing.assert_array_equal(a, np.where(sent, 0, delta.numpy()),
                                      err_msg=path)
        sent &= mags != 0
        jsent = (b == 0) & (mags != 0)
        both = ~sent & ~jsent
        noise = NOISE * max(np.abs(a - b)[both].max(), 1e-12)
        np.testing.assert_allclose(a[both], b[both], rtol=RTOL, atol=ATOL,
                                   err_msg=path)
        # a delta within the noise of 0 reads as 0 in the reference's
        # residual whether it was sent or not: only larger ones can tell
        flip = (sent != jsent) & (mags > noise)
        kth = np.sort(mags, axis=1)[:, -k][:, None]
        assert (np.abs(mags - kth)[flip] <= noise).all(), path
        assert flip.sum(1).max() <= max(2, k // 1000), path
        exact += not flip.any()
        swaps += int(flip.sum()) // 2
        # params: equal off the swapped coordinates, within a delta on them
        pa = tp.numpy().reshape(delta.shape)
        pb = np.asarray(jpar).reshape(delta.shape)
        off = ~flip.any(0)
        np.testing.assert_allclose(pa[:, off], pb[:, off], rtol=RTOL,
                                   atol=ATOL, err_msg=path)
        assert (np.abs(pa - pb)[:, ~off] <= 2 * kth.max()).all(), path
    # small leaves have wide gaps: most fires select exactly the same
    assert exact >= 0.75 * len(fires), (exact, swaps)


def test_markov_task_with_injected_logits_matches_jax():
    logits, floor = jsyn.make_markov_task(64, seed=5)
    tl, tfloor = tsyn.make_markov_task(64, device="cpu",
                                       logits=np.asarray(logits))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(logits))
    assert abs(tfloor - floor) <= 1e-5 * abs(floor)
    # a chain that is deterministic in fp32: each token's successor is
    # its row's argmax, in the port's samples as in the reference's
    peaked = np.asarray(logits) * 1e4
    tl, tfloor = tsyn.make_markov_task(64, device="cpu", logits=peaked)
    assert abs(tfloor) < 1e-3
    b = tsyn.markov_lm_batch(torch.Generator().manual_seed(0), 4, 33, tl)
    jb = jsyn.markov_lm_batch(jax.random.PRNGKey(0), 4, 33,
                              jnp.asarray(peaked))
    for toks, labels in ((b["tokens"].numpy(), b["labels"].numpy()),
                         (np.asarray(jb["tokens"]),
                          np.asarray(jb["labels"]))):
        assert toks.shape == labels.shape == (4, 33)
        np.testing.assert_array_equal(labels, peaked.argmax(-1)[toks])
        np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    assert b["tokens"].dtype == torch.int32


def test_loader_shapes_streams_and_refusals():
    _, cfg = _cfgs("rwkv6-1.6b")
    topo, hier = HierTopology(1, 2, 2), HierAvgParams(k1=2, k2=4)

    def sample(gen, n):
        return make_train_batch(gen, cfg, batch=n, seq_len=8)

    a = HierDataLoader(sample, topo=topo, hier=hier, per_learner_batch=3,
                       seed=7, device="cpu")
    assert a.tokens_per_round == 4 * 4 * 3
    r0, r1 = a.next_round(), a.next_round()
    assert r0["tokens"].shape == hier.batch_dims + topo.shape + (3, 8)
    assert r0["tokens"].dtype == torch.int32
    assert int(r0["tokens"].max()) < cfg.vocab_size
    assert not torch.equal(r0["tokens"], r1["tokens"])
    b = HierDataLoader(sample, topo=topo, hier=hier, per_learner_batch=3,
                       seed=7, device="cpu")
    assert torch.equal(b.next_round()["labels"], r0["labels"])
    # every (step, learner) cell draws its own stream
    cells = r0["tokens"].reshape(-1, 3 * 8)
    assert len({tuple(c.tolist()) for c in cells}) == cells.shape[0]
    # on a mesh of ranks (here rank 3 of (1, 2, 2, 1, 1), no world needed
    # to read its block) a round is the rank's block of the whole round
    from repro_torch.parallel.sharding import RankMesh
    mesh = RankMesh((1, 2, 2, 1, 1), ("pod", "group", "local", "fsdp",
                                      "model"), rank=3)
    mine = HierDataLoader(sample, topo=topo, hier=hier, per_learner_batch=3,
                          seed=7, mesh=mesh, device="cpu").next_round()
    nd = len(hier.batch_dims)
    for k in r0:
        assert torch.equal(mine[k], mesh.take_block(r0[k], dim=nd))
    # the encoder-decoder's batches (stub frames beside the tokens) go
    # through the loader like any other: every leaf gets the round's dims
    acfg = get_config("seamless-m4t-large-v2").reduced()
    ar = HierDataLoader(lambda gen, n: make_train_batch(gen, acfg, n, 8),
                        topo=topo, hier=hier, per_learner_batch=3, seed=7,
                        device="cpu").next_round()
    lead = hier.batch_dims + topo.shape + (3,)
    assert ar["frames"].shape == lead + (4, acfg.d_model)
    assert ar["tokens"].shape == ar["labels"].shape == lead + (8,)


def test_rwkv_serving_entry_points_raise():
    """The RWKV serving entry points, once refused, now run on the CPU:
    a prefill from the training tree, then decode steps whose states
    continue the prefill's (teacher-forced, they equal a prefill of the
    longer prompt)."""
    _, cfg = _cfgs("rwkv6-1.6b")
    bundle = build(cfg, device="cpu")
    params = bundle.init()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32))
    logits, cache = bundle.prefill(params, {"tokens": toks[:, :9]})
    assert logits.shape == (2, cfg.padded_vocab) and len(cache) == \
        cfg.n_layers
    for t in range(9, 12):
        logits, cache = bundle.decode_step(params, toks[:, t], cache)
    want, full = bundle.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    for c, f in zip(cache, full):
        for name in ("tm_shift", "wkv", "cm_shift"):
            np.testing.assert_allclose(c[name].numpy(), f[name].numpy(),
                                       rtol=1e-4, atol=1e-5)


def test_train_cli_runs_one_round_on_cpu(capsys):
    ttrain.main(["--arch", "rwkv6-1.6b", "--rounds", "1", "--learners", "4",
                 "--s", "2", "--batch", "2", "--seq", "16", "--device",
                 "cpu"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-1.6b-reduced device=cpu" in out
    line = [ln for ln in out.splitlines() if ln.startswith("round   0")][0]
    loss = float(line.split("loss=")[1].split()[0])
    assert np.isfinite(loss) and abs(loss - np.log(512)) < 1.0


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen2-vl-2b"])
def test_train_cli_runs_moe_and_vlm_on_cpu(arch, capsys):
    """--arch takes the MoE and VLM families, as the reference's CLI does
    (the VLM batches carry the stub's patch embeddings)."""
    ttrain.main(["--arch", arch, "--rounds", "1", "--learners", "4", "--s",
                 "2", "--batch", "2", "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced device=cpu" in out
    loss = float(_round_line(out).split("loss=")[1].split()[0])
    assert np.isfinite(loss) and abs(loss - np.log(512)) < 1.0


@pytest.mark.parametrize("flag,item", [
    (["--autotune", "no-such-calibration.json"],
     "no-such-calibration.json"), (["--fsdp", "2"], "torchrun")])
def test_train_cli_refuses_unported_flags(flag, item, monkeypatch):
    """Both flags are ported and refuse only what they cannot run:
    ``--autotune`` a calibration artifact that does not exist (naming it;
    tests/test_torch_autotune.py trains with one), ``--fsdp 2`` a run
    without a process group (naming torchrun)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    err = FileNotFoundError if "autotune" in flag[0] else RuntimeError
    with pytest.raises(err, match=item):
        ttrain.main(["--arch", "rwkv6-1.6b", "--device", "cpu", *flag])


def test_train_cli_refuses_telemetry_under_torchrun(monkeypatch):
    """``--telemetry`` under torchrun is no longer refused: the launcher
    goes on to join the world (here a stand-in that stops it), and the
    statistics are taken across the ranks (tests/test_torch_distributed.py
    holds them)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")

    class Joined(Exception):
        pass

    def join(args, topo, device):
        assert args.telemetry
        raise Joined

    monkeypatch.setattr(ttrain, "_join_world", join)
    with pytest.raises(Joined):
        ttrain.main(["--arch", "rwkv6-1.6b", "--device", "cpu",
                     "--telemetry"])


_CLI = ["--arch", "rwkv6-1.6b", "--rounds", "1", "--learners", "4", "--s",
        "2", "--batch", "2", "--seq", "16", "--device", "cpu"]


def _round_line(out, r=0):
    return [ln for ln in out.splitlines()
            if ln.startswith(f"round {r:3d}")][0]


@pytest.mark.parametrize("flag", ["--ckpt", "--faults", "--telemetry",
                                  "--metrics-out", "--trace-out",
                                  "--profile-dir"])
def test_train_cli_runs_each_flag(flag, tmp_path, capsys):
    """Each flag the CLI took over from the reference, alone, on the
    CPU, with its output checked."""
    import gzip
    import json

    from repro.checkpoint import load_checkpoint as jload
    from repro_torch.checkpoint import checkpoint as tck
    from repro_torch.telemetry import validate_jsonl
    path = str(tmp_path / "out")
    arg = {"--faults": ["crash:0.5/flaky:group:0.5/straggler:0.5"],
           "--telemetry": []}.get(flag, [path])
    ttrain.main(_CLI + ["--rounds", "2", flag, *arg])
    out = capsys.readouterr().out
    loss = float(_round_line(out).split("loss=")[1].split()[0])
    assert np.isfinite(loss)
    if flag == "--ckpt":
        arrays = tck.load_checkpoint(path)
        assert sorted(arrays) == sorted(jload(path))
        assert tck.checkpoint_step(path) == 8          # 2 rounds of 4 steps
        cfg = get_config("rwkv6-1.6b").reduced()
        like = build(cfg, device="cpu").init_train(
            torch.Generator().manual_seed(0))
        back = tck.restore_checkpoint(path, like)
        assert all(np.isfinite(x.numpy()).all() for x in leaves(back))
    elif flag == "--faults":
        assert "faults=crash:0.5/flaky:group:0.5:1/straggler:0.5:1.5" in out
        fracs = [_round_line(out, r).split("active=")[1].split()[0]
                 for r in (0, 1)]
        assert fracs[0] != fracs[1] or "0.50" in fracs[0], fracs
        assert "wall~" in _round_line(out, 1)
    elif flag == "--telemetry":
        ttrain.main(_CLI + ["--rounds", "2"])
        plain = capsys.readouterr().out
        for r in (0, 1):                    # a pure observer: same losses
            assert _round_line(plain, r).split("(")[0] \
                == _round_line(out, r).split("(")[0]
    elif flag == "--metrics-out":
        rows = validate_jsonl(path)
        assert [r["round"] for r in rows] == [0, 1]
        assert f"{rows[0]['loss']:.4f}" == f"{loss:.4f}"
    elif flag == "--trace-out":
        with open(path) as f:
            ev = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
        names = {e["name"] for e in ev}
        # the round's own spans, measured, inside each round's device span
        assert {"round[0]", "round[1]", "data", "device", "host_sync",
                "hier.round", "hier.step", "hier.fire.local",
                "hier.fire.global", "comm.compress", "comm.mean"} <= names
        assert {e["cat"] for e in ev} == {"host", "device"}
        dev = [e for e in ev if e["name"] == "device"]
        for e in ev:
            if e["name"].startswith(("hier.", "comm.")):
                assert any(d["ts"] <= e["ts"] and e["ts"] + e["dur"]
                           <= d["ts"] + d["dur"] + 1e-3 for d in dev), e
    else:
        with gzip.open(f"{path}/trace.json.gz", "rt") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"round[0]", "device", "hier.round", "hier.fire.global",
                "comm.finalize"} <= names
