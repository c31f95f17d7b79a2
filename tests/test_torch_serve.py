"""The port's paged serving engine against the JAX package's.

Both engines serve the same seeded requests on the same weights
(starcoder2-15b ``.reduced()``, G = 2, window 64, fp32 params and cache):
greedy tokens, request order, per-request decode steps, refill events and
the pool's high-water mark must be identical, and the pool must come back
whole.  The ``BlockAllocator`` invariants of ``tests/test_paged.py`` are
held against the port's copy, and the port's serve launcher is run once
on the CPU, paged and dense (the wave engine's own tests are in
``tests/test_torch_serve_dense.py``).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import PagedServeEngine as JEngine  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serve import (BlockAllocator, GenerationConfig,  # noqa: E402
                               PagedServeEngine, cache_bytes, page_bytes,
                               pages_for, pool_pages)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENGINE_KW = dict(slots=2, page_size=8, max_len=96, prefill_chunk=16)


@pytest.fixture(scope="module")
def engines():
    jc = dataclasses.replace(jget_config("starcoder2-15b").reduced(),
                             n_kv_heads=2)
    tc = dataclasses.replace(get_config("starcoder2-15b").reduced(),
                             n_kv_heads=2)
    jb = jbuild(jc, cache_dtype=jnp.float32, decode_impl="xla")
    jparams = jb.init(jax.random.PRNGKey(0))
    tb = build(tc, cache_dtype=torch.float32, device="cpu")
    model = tb.init()
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), tc, device="cpu"))
    rng = np.random.default_rng(5)
    lens = [5, 80, 23, 41, 9]
    reqs = [rng.integers(0, jc.vocab_size, size=n).astype(np.int32)
            for n in lens]
    budgets = [6, 9, 3, 12, 7]

    def serve(eos_id=-1):
        jeng = JEngine(jb, jparams, cache_dtype=jnp.float32,
                       gen=JGen(max_new_tokens=8, eos_id=eos_id), **ENGINE_KW)
        teng = PagedServeEngine(tb, model, cache_dtype=torch.float32,
                                gen=GenerationConfig(max_new_tokens=8,
                                                     eos_id=eos_id),
                                **ENGINE_KW)
        return (jeng, jeng.serve_queue(reqs, max_new=budgets),
                teng, teng.serve_queue(reqs, max_new=budgets))

    plain = serve()
    # EOS: the third token of the longest-budget request
    eos = int(plain[1][3].tokens[2])
    return {"plain": plain, "eos": serve(eos), "eos_id": eos,
            "budgets": budgets}


def _assert_same(run):
    jeng, jres, teng, tres = run
    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        np.testing.assert_array_equal(t.prompt, j.prompt)
        assert (t.steps, t.decode_steps) == (j.steps, j.decode_steps)
    js, ts = jeng.steady_state_summary(), teng.steady_state_summary()
    for key in ("requests", "tokens", "decode_steps", "wasted_ratio",
                "refill_events", "peak_pages_in_use", "pool_pages",
                "mean_occupancy"):
        assert ts[key] == js[key], key
    assert teng.refill_events == jeng.refill_events
    assert teng.alloc.peak_in_use == jeng.alloc.peak_in_use
    assert teng.alloc.free_pages == teng.alloc.n_pages - 1


def test_engines_agree_greedy_with_budgets(engines):
    _assert_same(engines["plain"])
    _, _, teng, tres = engines["plain"]
    assert [r.steps for r in tres] == engines["budgets"]
    assert teng.refill_events > 0


def test_engines_agree_with_eos(engines):
    _assert_same(engines["eos"])
    tres = engines["eos"][3]
    r = tres[3]
    assert r.tokens[-1] == engines["eos_id"] and len(r.tokens) <= 3
    assert r.decode_steps == len(r.tokens) - 1


def test_pool_tensors_are_updated_in_place(engines):
    teng = engines["plain"][2]
    before = [p["k"].data_ptr() for p in teng.pages]
    teng.serve_queue([np.arange(1, 12, dtype=np.int32)], max_new=[3])
    assert [p["k"].data_ptr() for p in teng.pages] == before


# --------------------- accounting and the allocator -------------------- #

@pytest.mark.parametrize("arch", ["yi-34b", "starcoder2-15b",
                                  "deepseek-v2-lite-16b",
                                  "seamless-m4t-large-v2", "hymba-1.5b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_accounting_matches_reference(arch, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jc, tc = jget_config(arch), get_config(arch)
    assert jkv.cache_bytes(jc, 3, 4096, cache_dtype=jdt) == \
        cache_bytes(tc, 3, 4096, cache_dtype=tdt)
    assert jkv.page_bytes(jc, 16, cache_dtype=jdt) == \
        page_bytes(tc, 16, cache_dtype=tdt)
    assert jkv.pool_pages(jc, 16, budget_bytes=1 << 30, cache_dtype=jdt) \
        == pool_pages(tc, 16, budget_bytes=1 << 30, cache_dtype=tdt)


def test_starcoder2_page_is_80_kib_per_token():
    cfg = get_config("starcoder2-15b")
    assert page_bytes(cfg, 1) == 2 * 4 * 128 * 2 * 40 == 80 * 1024
    assert pages_for(17, 16) == 2 and pages_for(16, 16) == 1
    assert pool_pages(cfg, 16, slots=3, max_len=64) == 3 * 4 + 1


def test_block_allocator_reserve_take_release():
    a = BlockAllocator(6)                 # 5 usable pages + null
    assert a.free_pages == 5 and a.unreserved_pages == 5
    assert a.reserve(3)
    assert not a.reserve(3)               # only 2 unreserved left
    assert a.reserve(2)
    p1, p2 = a.take(), a.take()
    assert p1 != p2 and 0 < p1 < 6 and 0 < p2 < 6
    assert a.free_pages == 3
    a.release([p1, p2], reserved_left=3)  # finish early: 3 unused units
    assert a.free_pages == 5 and a.unreserved_pages == 5
    assert a.peak_in_use == 2


def test_block_allocator_never_hands_out_null_page():
    a = BlockAllocator(4)
    assert a.reserve(3)
    pages = [a.take() for _ in range(3)]
    assert 0 not in pages and sorted(pages) == [1, 2, 3]


def test_block_allocator_misuse_raises():
    a = BlockAllocator(4)
    with pytest.raises(RuntimeError, match="without a matching reserve"):
        a.take()
    assert a.reserve(2)
    p = a.take()
    with pytest.raises(ValueError, match="bad page id"):
        a.release([0])
    with pytest.raises(ValueError, match="bad page id"):
        a.release([7])
    a.release([p], reserved_left=1)
    with pytest.raises(ValueError, match="double free"):
        a.release([p])
    with pytest.raises(ValueError, match="bad reservation release"):
        a.release([], reserved_left=5)
    with pytest.raises(ValueError, match=">= 2 pages"):
        BlockAllocator(1)


def test_block_allocator_reuse_is_immediate():
    a = BlockAllocator(5)                 # 4 usable
    assert a.reserve(4)
    held = [a.take() for _ in range(4)]
    assert not a.reserve(1)               # pool exhausted
    a.release(held[:2])
    assert a.reserve(2)                   # freed pages immediately usable
    again = [a.take(), a.take()]
    assert set(again) == set(held[:2])
    a.release(again)
    a.release(held[2:])
    assert a.free_pages == 4


# ----------------------------- launcher -------------------------------- #

def test_serve_launcher_cpu_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "starcoder2-15b", "--reduced", "--paged", "--device", "cpu",
         "--requests", "3", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "3 requests, 12 tokens" in proc.stdout
    assert "steady-state: engine=paged" in proc.stdout


def test_serve_launcher_dense_path_not_ported(capsys, tmp_path):
    """The dense path, once refused, now serves: without ``--paged`` the
    launcher runs the wave engine and ``--metrics-out`` writes its
    summary row."""
    from repro_torch.launch import serve
    from repro_torch.telemetry import validate_jsonl
    out = tmp_path / "rows.jsonl"
    serve.main(["--arch", "starcoder2-15b", "--device", "cpu",
                "--requests", "3", "--max-new", "4",
                "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert "3 requests, 12 tokens / 9 decode steps" in text
    assert "steady-state: engine=dense" in text
    rows = validate_jsonl(str(out))
    assert [r["subsystem"] for r in rows] == ["serve_summary"]
    assert rows[0]["engine"] == "dense" and rows[0]["tokens"] == 12
