"""The port's dry run (``repro_torch/launch/{hlo_analysis,cases,dryrun,
explore}.py``) against the reference's ``repro/launch`` modules: the
roofline arithmetic, the layout parser, the reference placement's bytes
per device (the reference side in one child process with 512 forced host
devices, ``build_case`` and ``eval_shape`` only), the kernels' shape
functions against their plain versions, and the CLIs on the CPU."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.launch import cases as ref_cases  # noqa: E402
from repro.launch import hlo_analysis as ref_ha  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import HierAvgParams  # noqa: E402
from repro_torch.kernels import ops, ref as kref  # noqa: E402
from repro_torch.launch import analytic  # noqa: E402
from repro_torch.launch import cases, hlo_analysis as ha  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _one_thread_env():
    return dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu")


# --------------------------------------------------------------------- #
# hlo_analysis

@pytest.mark.parametrize("kind", KINDS)
def test_ring_factor_equals_reference(kind):
    for n in (1, 2, 3, 8, 16, 256):
        assert ha._ring_factor(kind, n) == ref_ha._ring_factor(kind, n)


def _ops(mod):
    rs = np.random.RandomState(3)
    return [mod.CollectiveOp(k, int(v), int(n),
                             v * mod._ring_factor(k, int(n)))
            for k, v, n in zip(rs.choice(KINDS, 12),
                               rs.randint(1, 1 << 30, 12),
                               rs.choice([1, 2, 4, 16], 12))]


def test_collective_summary_equals_reference():
    assert ha.collective_summary(_ops(ha)) == \
        ref_ha.collective_summary(_ops(ref_ha))


@pytest.mark.parametrize("steps", [1, 8])
def test_roofline_terms_equal_reference(monkeypatch, steps):
    """Exact once the reference's TPU constants are the port's H100 ones
    (the port imports them from launch/analytic.py)."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref_ha, name, getattr(analytic, name))
    cost = {"flops": 3.7e15, "bytes accessed": 5.1e11}
    got = ha.roofline_terms(cost, _ops(ha), model_flops_per_device=2.9e15,
                            steps=steps)
    want = ref_ha.roofline_terms(cost, _ops(ref_ha),
                                 model_flops_per_device=2.9e15, steps=steps)
    assert got == want


# --------------------------------------------------------------------- #
# cases

@pytest.mark.parametrize("spec", ["32x4x1x2", "32x4x1x2:1", "2x2x4x16:8",
                                  "1x1x16x16:32"])
def test_parse_layout_equals_reference(spec):
    a, b = cases.parse_layout(spec), ref_cases.parse_layout(spec)
    assert (a.groups, a.local, a.fsdp, a.tp, a.microbatch) == \
        (b.groups, b.local, b.fsdp, b.tp, b.microbatch)


def test_default_hier_params_equal_reference():
    from repro.configs import get_config as ref_get
    for arch in ("yi-34b", "rwkv6-1.6b"):
        a = cases.default_hier_params(get_config(arch))
        b = ref_cases.default_hier_params(ref_get(arch))
        assert (a.k1, a.k2, a.plan) == (b.k1, b.k2, b.plan)


# (arch, shape, multi_pod, plan): a fsdp-1 train case, a fsdp-4 train
# case on two pods whose top-k EF lives in the codec view, a hybrid
# decode and a prefill
PLACEMENT_CASES = [
    ("rwkv6-1.6b", "train_4k", False, None),
    ("starcoder2-15b", "train_4k", True, "local@4/global@8:topk:0.05"),
    ("hymba-1.5b", "decode_32k", False, None),
    ("yi-34b", "prefill_32k", False, None),
]

_REF_PLACEMENT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import warnings
warnings.simplefilter("ignore")
import jax, numpy as np
from repro.configs import get_config
from repro.configs.base import HierAvgParams
from repro.launch.cases import build_case
out = {}
for arch, shape, mp, plan in json.loads(sys.argv[1]):
    kw = {"hier": HierAvgParams(plan=plan)} if plan else {}
    case = build_case(get_config(arch), shape, multi_pod=mp, **kw)
    shard = case.jitted._jit_info.in_shardings_leaves
    flat = jax.tree.leaves(case.arg_specs)
    assert len(shard) == len(flat)
    out[f"{arch}:{shape}:{mp}"] = sum(
        int(np.prod(s.shard_shape(x.shape))) * np.dtype(x.dtype).itemsize
        for s, x in zip(shard, flat))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_bytes():
    """The reference's bytes per device (the sum of each argument's
    ``NamedSharding.shard_shape`` bytes), one child process for all."""
    proc = subprocess.run(
        [sys.executable, "-c", _REF_PLACEMENT, json.dumps(PLACEMENT_CASES)],
        capture_output=True, text=True, env=_one_thread_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch,shape,mp,plan", PLACEMENT_CASES)
def test_reference_placement_equals_reference(reference_bytes, arch, shape,
                                              mp, plan):
    kw = {"hier": HierAvgParams(plan=plan)} if plan else {}
    case = cases.build_case(get_config(arch), shape, multi_pod=mp, **kw)
    got = cases.reference_placement(case)
    assert got["devices"] == (512 if mp else 256)
    assert got["bytes_per_device"] == reference_bytes[f"{arch}:{shape}:{mp}"]


@pytest.mark.slow
def test_reference_placement_equals_reference_every_case():
    """Every arch x shape on both meshes (80 cases, ~2 min): the
    reference placement's bytes per device equal the reference's."""
    from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES
    every = [(a, s, mp, None) for a in ALL_ARCHS for s in INPUT_SHAPES
             for mp in (False, True)]
    proc = subprocess.run(
        [sys.executable, "-c", _REF_PLACEMENT, json.dumps(every)],
        capture_output=True, text=True, env=_one_thread_env(), timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.splitlines()[-1])
    for arch, shape, mp, _ in every:
        case = cases.build_case(get_config(arch), shape, multi_pod=mp)
        assert cases.reference_placement(case)["bytes_per_device"] == \
            want[f"{arch}:{shape}:{mp}"], (arch, shape, mp)


def test_port_rank_holds_a_learner():
    """Training on rank_mesh: a rank holds one learner's whole parameters
    (model 1), and its EF state one row a bucket: its fsdp shard's."""
    case = cases.build_case(get_config("starcoder2-15b"), "train_4k",
                            multi_pod=True,
                            hier=HierAvgParams(
                                plan="local@4/global@8:topk:0.05"))
    state = case.port.args[0]
    lay = get_config("starcoder2-15b").layout
    assert case.port.mesh.size == 2 * lay.groups * lay.local * lay.fsdp
    assert all(tuple(x.shape[:3]) == (1, 1, 1)
               for x in cases.leaves(state.params))
    whole = case.arg_specs[0]
    n_one = sum(x.numel() for x in cases.leaves(whole.params)) \
        // (2 * lay.groups * lay.local)
    assert sum(x.numel() for x in cases.leaves(state.params)) == n_one
    ef = state.comm_state["global"]
    layout = case.port.plan.levels[-1].reducer.layout_for(state.params)
    assert sum(b.shards > 1 for b in layout.buckets) > 0
    assert [tuple(x.shape[:3]) for x in cases.leaves(ef.err)] == \
        [(1, 1, 1)] * layout.n_buckets


# --------------------------------------------------------------------- #
# the kernels' shape functions against their plain versions

def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _meta(tree):
    return [(tuple(x.shape), x.dtype) for x in cases.leaves(tree)]


def _same_outputs(fn, *args):
    """fn's outputs on real tensors through the plain versions, and on
    their fake copies through the shape functions: equal shapes and
    dtypes."""
    plain = fn(*args, impl="plain")
    with _fake() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        shaped = fn(*fake, impl="auto")
    assert _meta(plain) == _meta(shaped)
    return plain, shaped


@pytest.mark.parametrize("rows,n,k", [(4, 300, 7), (2, 4096, 100)])
def test_topk_and_qint8_shapes(rows, n, k):
    x = torch.randn(rows, n)
    _same_outputs(lambda x, impl: ops.topk_compress(x, k, impl=impl), x)
    _same_outputs(lambda x, impl: ops.topk_compress_many(
        [x, x[:, :n // 2]], [k, k // 2 + 1], impl=impl), x)
    wire, _ = _same_outputs(lambda x, impl: ops.qint8_pack(x, 256,
                                                           impl=impl), x)
    _same_outputs(lambda w, impl: ops.qint8_unpack(w, n, impl=impl), wire)


@pytest.mark.parametrize("shape", [(3, 40, 2), (2, 5, 64, 4)])
def test_batched_qr_shapes(shape):
    p = torch.randn(*shape)
    _same_outputs(lambda p, impl: ops.batched_qr(p, impl=impl), p)
    _same_outputs(lambda p, impl: ops.batched_qr_many([p, p[..., :1]],
                                                      impl=impl), p)


@pytest.mark.parametrize("b,pages,lengths", [(2, 6, (5, 17)),
                                             (3, 9, (1, 30, 64))])
def test_flash_decode_shapes(b, pages, lengths):
    hq, hkv, d, page = 4, 2, 32, 8
    q = torch.randn(b, hq, d)
    kp = torch.randn(hkv, b * pages + 1, page, d)
    vp = torch.randn(hkv, b * pages + 1, page, d)
    tables = torch.arange(1, b * pages + 1, dtype=torch.int32).reshape(
        b, pages)
    lens = torch.tensor(lengths, dtype=torch.int32)
    _same_outputs(lambda q, kp, vp, t, ln, impl: ops.flash_decode(
        q, kp, vp, t, ln, impl=impl), q, kp, vp, tables, lens)


def _saved(out):
    return [(tuple(t.shape), t.dtype) for t in out.grad_fn.saved_tensors]


@pytest.mark.parametrize("b,s,hq,hkv,d,window",
                         [(2, 48, 4, 2, 32, 0), (1, 130, 6, 3, 64, 32)])
def test_attention_shapes_and_saved(b, s, hq, hkv, d, window):
    q = torch.randn(b, s, hq, d, requires_grad=True)
    k = torch.randn(b, s, hkv, d, requires_grad=True)
    v = torch.randn(b, s, hkv, d, requires_grad=True)
    out = ops.flash_attention(q, k, v, window=window, impl="plain")
    saved = _saved(out)
    dq = torch.autograd.grad(out.sum(), (q, k, v))
    plain_in = [t.detach() for t in (q, k, v)]
    with _fake() as mode:
        fq, fk, fv = (mode.from_tensor(t).requires_grad_() for t in plain_in)
        fout = ops.flash_attention(fq, fk, fv, window=window)
        assert _saved(fout) == saved
        fdq = torch.autograd.grad(fout.sum(), (fq, fk, fv))
    assert _meta(fout) == _meta(out) and _meta(fdq) == _meta(dq)


@pytest.mark.parametrize("b,s,h,d", [(2, 40, 2, 32), (1, 130, 3, 64)])
def test_wkv_shapes_and_saved(b, s, h, d):
    r, k, v = (torch.randn(b, s, h, d, requires_grad=True)
               for _ in range(3))
    w = torch.rand(b, s, h, d).requires_grad_()
    u = torch.randn(h, d, requires_grad=True)
    s0 = torch.zeros(b, h, d, d)
    args = (r, k, v, w, u, s0)
    y, st = ops.rwkv6_wkv(*args, impl="plain")
    saved = _saved(y)
    grads = torch.autograd.grad(y.sum(), (r, k, v, w, u))
    plain_in = [(t.detach(), t.requires_grad) for t in args]
    with _fake() as mode:
        fargs = [mode.from_tensor(t).requires_grad_(g) for t, g in plain_in]
        fy, fst = ops.rwkv6_wkv(*fargs)
        assert _saved(fy) == saved
        fgrads = torch.autograd.grad(fy.sum(), fargs[:5])
    assert _meta((fy, fst)) == _meta((y, st))
    assert _meta(fgrads) == _meta(grads)


def test_shape_functions_count_the_kernels_flops():
    from repro_torch.kernels import shapes
    shapes.FLOPS[0] = 0.0
    with _fake():
        q = torch.empty(2, 64, 4, 32)
        k = torch.empty(2, 64, 2, 32)
        ops.flash_attention(q, k, k, window=16)
    assert shapes.FLOPS[0] == 4 * 32 * 4 * 2 * shapes.visible_pairs(64, 16)
    assert shapes.visible_pairs(64, 16) == sum(min(i + 1, 16)
                                               for i in range(64))
    assert kref.WKV_CHUNK == 64


# --------------------------------------------------------------------- #
# the CLIs on the CPU

def test_dryrun_cli_writes_its_record(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch rwkv6-1.6b --shape
    decode_32k --device cpu`` (the counterpart of tests/test_system.py's
    dry-run case) writes its record with the reference's keys."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "rwkv6-1.6b", "--shape", "decode_32k", "--device", "cpu", "--out",
         str(tmp_path)], capture_output=True, text=True,
        env=_one_thread_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK   rwkv6-1.6b__decode_32k__1pod" in proc.stdout
    rec = json.loads((tmp_path / "rwkv6-1.6b__decode_32k__1pod.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "chips", "notes", "memory",
                "collectives", "roofline", "roofline_per_step", "trace_s",
                "reference_placement", "port_rank"):
        assert key in rec
    assert rec["chips"] == 256 and rec["mesh"] == "1pod-256"
    mem = rec["memory"]
    assert mem["argument_bytes"] == rec["port_rank"]["bytes"]
    assert mem["peak_est_bytes"] >= mem["argument_bytes"] > 0
    assert mem["fits_one_h100"] is None       # no card: not measured


def test_dryrun_refuses_without_cuda():
    from repro_torch.launch import dryrun, explore
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(SystemExit, match="--device cpu"):
        dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k"])
    with pytest.raises(SystemExit, match="--device cpu"):
        explore.main(["--arch", "rwkv6-1.6b"])


def test_explore_runs(capsys):
    from repro_torch.launch import explore
    explore.main(["--arch", "rwkv6-1.6b", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "projected MFU at the binding term" in out
    explore.main(["--arch", "mistral-large-123b", "--sweep-k2",
                  "--multi-pod", "--device", "cpu"])
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("K2=")]
    assert len(rows) == 7


def test_explore_mfu_is_the_h100s():
    """The projected MFU divides by the H100's peak, not the TPU's."""
    from repro_torch.launch import explore
    r = explore.show(get_config("yi-34b"), "train_4k", multi_pod=False,
                     hier=HierAvgParams(4, 8))
    binding = max(r.compute_s, r.memory_s, r.collective_s)
    assert analytic.PEAK_FLOPS == 989e12
    assert r.model_flops_per_device / (binding * analytic.PEAK_FLOPS) < 1
