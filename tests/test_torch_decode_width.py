"""The decode kernels K6 - K9 at head widths 128 (llama3_2_3b's) and 80
(zamba2_2_7b's), on the CPU: the plain versions that the wrappers run for
CPU tensors (and that ``chip_smoke.py`` holds the CUDA kernels to) against
the reference's Pallas kernels in interpret mode at G 3, the wrappers'
width checks, and the launch plan at 128.
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import decode_kernel  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro_torch.kernels import attention_ops as tops  # noqa: E402

ATOL = 1e-5  # fp32 plain version vs the Pallas kernel, sums in another order
D, KH, G = 128, 2, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _q8(x):
    codes, scales = jattn.quantize_kv_token(jnp.asarray(x))
    return np.asarray(codes), np.asarray(scales)


def _ring_case(d=D):
    """A ring of L 40 (the Pallas kernel's blocks of 20 divide it; the
    port's virtual pages of 16 leave a ragged last one) for 4 rows: row 0
    full and unwrapped, row 1 wrapped (positions 21 - 60), row 2 inactive,
    row 3 holding 0 - 10; head width ``d``."""
    rng = np.random.default_rng(11)
    b, length = 4, 40
    qpos = np.array([39, 60, -1, 10], np.int32)
    kpos = np.full((b, length), -1, np.int32)
    for row, qp in enumerate(qpos):
        for p in range(max(0, qp - length + 1), qp + 1):
            kpos[row, p % length] = p
    qf = (rng.normal(size=(b, KH, G, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.normal(size=(b, length, KH, d)).astype(np.float32)
    v = rng.normal(size=(b, length, KH, d)).astype(np.float32)
    return qf, k, v, kpos, qpos


def _paged_case(d=D):
    """Pools of 8-token pages for 4 slots of 40, 25 (its second page
    unallocated), 0 and 9 tokens; head width ``d``."""
    rng = np.random.default_rng(12)
    pg, npp, lens = 8, 8, (40, 25, 0, 9)
    n_pages = 1 + sum(-(-n // pg) for n in lens)
    pos = np.full((n_pages, pg), -1, np.int32)
    pt = np.full((len(lens), npp), -1, np.int32)
    pages = iter(rng.permutation(np.arange(1, n_pages)))
    for slot, n in enumerate(lens):
        for j in range(-(-n // pg)):
            page = next(pages)
            pt[slot, j] = page
            ln = min(pg, n - j * pg)
            pos[page, :ln] = np.arange(j * pg, j * pg + ln)
    pt[1, 1] = -1
    qpos = np.array([n - 1 if n else -1 for n in lens], np.int32)
    qf = (rng.normal(size=(len(lens), KH, G, d)) / np.sqrt(d)) \
        .astype(np.float32)
    k = rng.normal(size=(n_pages, pg, KH, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, pg, KH, d)).astype(np.float32)
    return qf, k, v, pos, pt, qpos


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("kind", ["K6", "K7", "K8", "K9"])
def test_plain_decode_d128_matches_reference_kernels(kind, window):
    """The plain K6 - K9 at head width 128 and G 3 against the reference's
    Pallas ``decode`` / ``decode_q8`` / ``decode_paged`` /
    ``decode_paged_q8`` in interpret mode, within ATOL; the inactive row
    exactly 0."""
    _check_plain_decode(kind, window, D)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("kind", ["K6", "K7", "K8", "K9"])
def test_plain_decode_d80_matches_reference_kernels(kind, window):
    """As above at head width 80 (zamba2_2_7b's)."""
    _check_plain_decode(kind, window, 80)


def _check_plain_decode(kind, window, d):
    scale = lambda s: jnp.asarray(s).astype(jnp.float32).transpose(  # noqa
        0, 2, 1)
    if kind in ("K6", "K7"):
        qf, k, v, kpos, qpos = _ring_case(d)
        jq, jpos, jqpos = (jnp.asarray(a) for a in (qf, kpos, qpos))
        if kind == "K6":
            ref = decode_kernel.decode(
                jq, jnp.asarray(k), jnp.asarray(v), jpos,
                jqpos.reshape(-1, 1), window=window, block=20,
                interpret=True)
            out = tops.decode(_t(qf), _t(k), _t(v), _t(kpos), _t(qpos),
                              window=window)
        else:
            (kc, ks), (vc, vs) = _q8(k * 2), _q8(v)
            ref = decode_kernel.decode_q8(
                jq, jnp.asarray(kc), jnp.asarray(vc), scale(ks), scale(vs),
                jpos, jqpos.reshape(-1, 1), window=window, block=20,
                interpret=True)
            out = tops.decode_q8(_t(qf), _t(kc), _t(vc), _t(ks), _t(vs),
                                 _t(kpos), _t(qpos), window=window)
    else:
        qf, k, v, pos, pt, qpos = _paged_case(d)
        jq, jpos, jpt, jqpos = (jnp.asarray(a) for a in (qf, pos, pt, qpos))
        if kind == "K8":
            ref = decode_kernel.decode_paged(
                jq, jnp.asarray(k), jnp.asarray(v), jpos, jpt,
                jqpos.reshape(-1, 1), window=window, interpret=True)
            out = tops.decode_paged(_t(qf), _t(k), _t(v), _t(pos), _t(pt),
                                    _t(qpos), window=window)
        else:
            (kc, ks), (vc, vs) = _q8(k * 2), _q8(v)
            ref = decode_kernel.decode_paged_q8(
                jq, jnp.asarray(kc), jnp.asarray(vc), scale(ks), scale(vs),
                jpos, jpt, jqpos.reshape(-1, 1), window=window,
                interpret=True)
            out = tops.decode_paged_q8(_t(qf), _t(kc), _t(vc), _t(ks),
                                       _t(vs), _t(pos), _t(pt), _t(qpos),
                                       window=window)
    assert out.shape == (4, KH, G, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert np.all(out.numpy()[2] == 0.0)


@pytest.mark.parametrize("d", [64, 128, 80, 96])
def test_check_decode_takes_64_and_128_only(d):
    """``_check_decode`` (every decode wrapper's CUDA-side check) takes
    head widths 64, 128 and zamba2's 80; 96 says no ROADMAP item queues
    it; a V of another width than Q and K is refused."""
    qf = torch.zeros(2, KH, G, d, dtype=torch.bfloat16)
    cache = torch.zeros(2, 8, KH, d, dtype=torch.bfloat16)
    pos = torch.zeros(2, 8, dtype=torch.int32)
    qpos = torch.zeros(2, dtype=torch.int32)
    args = (qf, cache, cache, (), pos, qpos, torch.bfloat16)
    if d in tops.DECODE_HEAD_DIMS:
        assert tops._check_decode("K6", *args).dtype == torch.int32
        with pytest.raises(ValueError, match="Dv = D"):
            tops._check_decode("K6", qf, cache, cache[..., :d // 2], (),
                               pos, qpos, torch.bfloat16)
        return
    with pytest.raises(ValueError, match="no ROADMAP item"):
        tops._check_decode("K6", *args)


@pytest.mark.parametrize("elem", [2, 1])
def test_decode_plan_at_llama_shapes(elem):
    """At llama's generate ring (B 4, 8 kv heads, G 3, L 1 088: 68 virtual
    pages) and serve shape (4 slots, 8 table entries) the plan fills the
    card with clusters of 8 at both widths; a round holds half the pages
    at 128 that it holds at 64 (capped at the rank's pages); the shared
    memory fits a block."""
    for npp in (68, 8):
        p64, p128 = (tops.decode_paged_plan(4, 8, npp, 16, 3, elem, d)
                     for d in (64, 128))
        assert p64.grid == p128.grid == 4 * 8 * 8
        assert p64.pages_per_rank == p128.pages_per_rank == -(-npp // 8)
        per = tops.PAGED_ROUND_BYTES // (2 * 16 * elem)
        for plan, d in ((p64, 64), (p128, 128)):
            assert plan.pages_per_round == min(plan.pages_per_rank,
                                               per // d)
            assert plan.smem <= tops.SMEM_MAX
        assert p128.smem >= p64.smem
    assert tops.decode_paged_plan(4, 8, 68, 16, 3, elem, 128) \
        .pages_per_round == (4 if elem == 2 else 8)


@pytest.mark.parametrize("d", [64, 128])
def test_row_limit_is_named_in_the_refusal(d):
    """A row of more keys than ``row_key_limit`` is refused before any
    launch, and the message states the limit at this width; a row of
    exactly the limit is planned."""
    qf = torch.zeros(1, 1, 4, d, dtype=torch.bfloat16)
    limit = tops.row_key_limit(1, 1, 16, 4, 2, d)
    assert 500_000 < limit < 1_000_000
    plan = tops._decode_plan("decode", qf, limit // 16, 16, 2)
    assert plan.smem <= tops.SMEM_MAX
    with pytest.raises(ValueError, match=f"at most {limit} keys"):
        tops._decode_plan("decode", qf, limit // 16 + 1, 16, 2)
