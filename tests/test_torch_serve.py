"""The port's serving engine against the JAX ``ServeEngine``, on the CPU:
token streams and wire bytes, plus the pool / scheduler invariants."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.pool import PagePool  # noqa: E402
from repro_torch.serve.scheduler import Request, SlotScheduler  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

CFG = get_config("tinyllava").reduced()
TCFG = torch_get_config("tinyllava").reduced()
PAGE = 8


@pytest.fixture(scope="module")
def case():
    """Five requests of mixed lengths through three slots: admissions in
    several prefill batches, padded prefill rows, retirements mid-flight."""
    jp = jtf.init_params(jax.random.PRNGKey(0), CFG)
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(5):
        plen = int(rng.integers(3, 20))
        reqs.append((rng.integers(1, CFG.vocab_size, plen).tolist(),
                     int(rng.integers(2, 7)),
                     rng.normal(size=(CFG.n_image_tokens, CFG.d_vision))
                     .astype(np.float32)))
    need = sum(-(-(CFG.n_image_tokens + len(t) + m) // PAGE)
               for t, m, _ in reqs)
    return jp, from_jax_params(jp, "cpu"), reqs, 1 + need


def _run(engine_cls, params, cfg, reqs, n_pages, **kw):
    eng = engine_cls(params, cfg, n_slots=3, page_size=PAGE,
                     n_pages=n_pages, **kw)
    rids = [eng.submit(t, max_new=m, image_embeds=img) for t, m, img in reqs]
    out = eng.run()
    return [out[r] for r in rids], eng


@pytest.mark.parametrize("split_wire", [False, True])
def test_engine_token_exact_vs_reference(case, split_wire):
    jp, tp, reqs, n_pages = case
    jkw = dict(split_wire=CFG.split.quant) if split_wire else {}
    tkw = dict(split_wire=TCFG.split.quant) if split_wire else {}
    ref, jeng = _run(JaxServeEngine, jp, CFG, reqs, n_pages, **jkw)
    out, teng = _run(ServeEngine, tp, TCFG, reqs, n_pages, device="cpu",
                     **tkw)
    assert out == ref
    assert [len(o) for o in out] == [m for _, m, _ in reqs]
    assert teng.stats["wire_bytes"] == jeng.stats["wire_bytes"]
    assert (teng.stats["wire_bytes"] > 0) == split_wire
    for key in ("prefill_batches", "decode_ticks", "tokens_emitted",
                "admitted", "retired", "page_table_buckets"):
        assert teng.stats[key] == jeng.stats[key], key
    if split_wire:  # packed 2-bit codes + 2 fp16 stats per prefill row
        row = -(-CFG.n_image_tokens * CFG.d_model * 2 // 8) + 4
        assert teng.stats["wire_bytes"] == teng.stats["prefill_rows"] * row
    teng.page_pool.check_invariants()
    assert teng.page_pool.n_live == 0


def test_engine_temperature_sampling_is_seeded(case):
    _, tp, reqs, n_pages = case
    runs = [_run(ServeEngine, tp, TCFG, reqs[:2], n_pages, device="cpu",
                 temperature=0.8, seed=s)[0] for s in (3, 3)]
    assert runs[0] == runs[1]


def test_engine_requires_cuda_unless_cpu_is_asked_for(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tp, _, n_pages = case
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tp, TCFG, n_slots=2, page_size=PAGE, n_pages=n_pages)


@pytest.mark.parametrize("kw,item", [
    (dict(lora_scale=0.5), "M9"),
    (dict(weight_quant="int4"), "M10")])
def test_engine_unported_options_raise(case, kw, item):
    """Options that once raised as unported now serve.  M9 (SplitLoRA
    serving, ROADMAP item M9a): ``lora_adapters=`` is merged once at
    construction, so the engine's tokens equal an engine's on
    ``merge_lora``'s params, and an empty adapter tree changes nothing;
    M10: the engine serves from packed int4 stores and reports their
    bytes."""
    from repro_torch.peft import init_lora_params, merge_lora

    _, tp, reqs, n_pages = case
    if item == "M9":
        ad = init_lora_params(torch.Generator().manual_seed(1), tp, 2,
                              b_scale=0.05)
        out, eng = _run(ServeEngine, tp, TCFG, reqs[:2], n_pages,
                        device="cpu", lora_adapters=ad, **kw)
        merged, _ = _run(ServeEngine, merge_lora(tp, ad, scale=0.5), TCFG,
                         reqs[:2], n_pages, device="cpu")
        assert out == merged
        assert [len(o) for o in out] == [m for _, m, _ in reqs[:2]]
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(eng.params), tree_leaves(merge_lora(tp, ad,
                                                            scale=0.5))))
        none, _ = _run(ServeEngine, tp, TCFG, reqs[:2], n_pages,
                       device="cpu", lora_adapters={})
        base, _ = _run(ServeEngine, tp, TCFG, reqs[:2], n_pages,
                       device="cpu")
        assert none == base
        return
    out, eng = _run(ServeEngine, tp, TCFG, reqs[:2], n_pages, device="cpu",
                    **kw)
    assert [len(o) for o in out] == [m for _, m, _ in reqs[:2]]
    assert 0 < eng.stats["weight_bytes_packed"] < \
        eng.stats["weight_bytes_dense"]


# ---------------------------------------------------------------------------
# page pool and scheduler (ported from tests/test_serve_engine.py)
# ---------------------------------------------------------------------------

def test_page_pool_random_admit_retire_trace():
    rng = np.random.default_rng(0)
    pool = PagePool(33)
    live = {}
    next_rid = 0
    for _ in range(300):
        if live and rng.random() < 0.4:
            rid = int(rng.choice(list(live)))
            n = pool.free_owner(rid)
            assert n == len(live.pop(rid))
        else:
            n = int(rng.integers(1, 5))
            if pool.can_alloc(n):
                pages = pool.alloc(n, next_rid)
                assert len(set(pages)) == n
                for p in pages:  # no aliasing, trash page never handed out
                    assert p != 0
                    for other in live.values():
                        assert p not in other
                live[next_rid] = pages
                next_rid += 1
        pool.check_invariants()
    for rid in list(live):
        pool.free_owner(rid)
    pool.check_invariants()
    assert pool.n_free == 32 and pool.n_live == 0


def test_scheduler_head_of_line_blocks_until_pages_free():
    pool = PagePool(5)  # 4 usable pages
    sched = SlotScheduler(2, pool, page_size=4)
    sched.submit(Request(rid=0, tokens=[1] * 10, max_new=6))   # 4 pages
    sched.submit(Request(rid=1, tokens=[1] * 2, max_new=2))    # 1 page
    admitted = sched.admit()
    assert [r.rid for r in admitted] == [0]
    # a slot is free, but rid 1 waits for pages instead of jumping the queue
    assert sched.admit() == []
    sched.retire(admitted[0], "length")
    assert [r.rid for r in sched.admit()] == [1]
