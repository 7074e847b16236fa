"""The port's sharding rules (``repro_torch/sharding/specs.py``) and
activation-sharding context (``repro_torch/sharding/ctx.py``) against the
JAX reference's, in one process, no mesh.

Every registered arch's ``reduced()`` parameter, batch and cache trees are
the reference's ``jax.eval_shape`` ones (the port's own parameter tree has
the same paths and shapes, checked here too); each spec must equal the
reference's ``PartitionSpec`` entry for entry, at ``{"data": 16, "model":
16}`` and ``{"data": 2, "model": 2}``, with FSDP on and off.
"""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS, get_config as jget_config  # noqa: E402
from repro.data.pipeline import make_pipeline as jpipeline  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding import ctx as jctx  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import attention_ops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import ctx  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

BIG = {"data": 16, "model": 16}
SMALL = {"data": 2, "model": 2}
SETTINGS = [(BIG, False), (BIG, True), (SMALL, False), (SMALL, True)]
SETTING_IDS = ["16x16", "16x16-fsdp", "2x2", "2x2-fsdp"]


def _jax_specs(tree):
    """'/'-joined path -> the reference spec as a tuple."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(k.key) for k in p): tuple(s) for p, s in flat}


def _port_specs(tree):
    return {"/".join(p): s for p, s in tree_flatten_with_path(tree)}


@pytest.fixture(scope="module")
def ref_params():
    """Every arch's reduced() parameter shapes, by ``jax.eval_shape``."""
    return {a: jax.eval_shape(lambda a=a: jtf.init_params(
        jax.random.PRNGKey(0), jget_config(a).reduced())) for a in ARCHS}


@pytest.mark.parametrize("axes,fsdp", SETTINGS, ids=SETTING_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, axes, fsdp, ref_params):
    """``param_pspecs`` (and through it ``leaf_pspec``) on the reduced tree
    equals the reference's, leaf for leaf."""
    tree = ref_params[arch]
    ours = _port_specs(specs.param_pspecs(tree, axes, fsdp=fsdp))
    ref = _jax_specs(jspecs.param_pspecs(tree, axes, fsdp=fsdp))
    assert ours == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_port_param_tree_matches_reference_shapes(arch, ref_params):
    """The port's own reduced tree has the reference's paths and shapes,
    so the specs above are the port's specs."""
    torch.manual_seed(0)
    ours = {"/".join(p): tuple(x.shape) for p, x in tree_flatten_with_path(
        ttf.init_params(get_config(arch).reduced(), device="cpu"))}
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_params[arch])
    ref = {"/".join(str(k.key) for k in p): tuple(x.shape) for p, x in flat}
    assert ours == ref


@pytest.mark.parametrize("axes,fsdp", SETTINGS, ids=SETTING_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_match_reference(arch, axes, fsdp):
    """``batch_pspecs`` (``positions`` replicated; batch 8 and batch 1,
    which no data axis divides) and ``cache_pspecs`` (heads, else
    head_dim; MLA latent; mamba state) equal the reference's.  The
    setting's FSDP flag sets the cache batch (8 or 1)."""
    cfg = jget_config(arch).reduced()
    for b in (8, 1):
        batch = next(jpipeline(cfg, b, 16))
        assert _port_specs(specs.batch_pspecs(batch, ("data",), axes)) \
            == _jax_specs(jspecs.batch_pspecs(batch, ("data",), axes))
    assert _port_specs(specs.batch_pspecs(batch, ("data",))) \
        == _jax_specs(jspecs.batch_pspecs(batch, ("data",)))
    caches = jax.eval_shape(lambda: jtf.init_caches(
        cfg, 8 if fsdp else 1, 32))
    dp = ("pod", "data")
    assert _port_specs(specs.cache_pspecs(caches, dp, axes)) \
        == _jax_specs(jspecs.cache_pspecs(caches, dp, axes))


def test_leaf_pspec_rules():
    """The reference's rule tests (``tests/test_sharding_ctx.py``) on the
    port, plus the rwkv6 small weights and the audio embedding."""
    L = specs.leaf_pspec
    assert L(("attn", "wq"), (4096, 4096), BIG) == (None, "model")
    assert L(("attn", "wo"), (4096, 4096), BIG) == ("model", None)
    assert L(("attn", "wq"), (4096, 4096), BIG, fsdp=True) \
        == ("data", "model")
    assert L(("embed", "emb"), (73448, 2560), BIG) == (None, None)
    assert L(("embed", "emb"), (128256, 3072), BIG) == ("model", None)
    assert L(("ffn", "w_gate"), (160, 5120, 1536), BIG, fsdp=True) \
        == ("model", "data", None)
    assert L(("client", "seg0", "attn", "wq"), (14, 3072, 3072), BIG,
             stacked=True) == (None, None, "model")
    assert L(("tmix", "maa_w1"), (4096, 160), BIG, fsdp=True) == (None, None)
    assert L(("embed", "emb"), (4, 2048, 2048), BIG, fsdp=True) \
        == (None, "model", "data")
    for shape, axes, fsdp in [((4096, 4096), BIG, True),
                              ((4, 2048, 2048), SMALL, False)]:
        for path in [("attn", "wq"), ("embed", "emb"), ("ffn", "w_up")]:
            assert L(path, shape, axes, fsdp=fsdp) == tuple(
                jspecs.leaf_pspec(path, shape, axes, fsdp=fsdp))


def test_state_and_opt_pspecs():
    """``state_pspecs`` mirrors the reference: moments share the parameter
    specs, the step is replicated."""
    from repro_torch.train.loop import TrainState
    params = {"attn": {"wq": torch.empty(8, 4)}, "ln": torch.empty(8)}
    st = TrainState(params=params, opt=dict(m=params, v=params, step=None),
                    step=None)
    got = specs.state_pspecs(st, SMALL, fsdp=True)
    assert got.params == {"attn": {"wq": ("data", "model")}, "ln": (None,)}
    assert got.opt == dict(m=got.params, v=got.params, step=())
    assert got.step == ()


class _Mesh:
    """What ``to_placements`` and ``head_placements`` read of a
    ``DeviceMesh``."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())
        self.mesh = np.zeros(self._sizes)

    def size(self, i):
        return self._sizes[i]


def test_to_placements_and_mesh_axes():
    """Spec entries become Shard(dim) on the named mesh dims, the rest
    Replicate; a tuple entry shards one dim over each of its axes."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh(pod=2, data=2, model=2)
    assert specs.mesh_axes(mesh) == {"pod": 2, "data": 2, "model": 2}
    assert specs.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert specs.to_placements((None, None), mesh) == (Replicate(),) * 3
    assert specs.to_placements(("data", "absent"), mesh) == (
        Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="two dims"):
        specs.to_placements(("data", "data"), mesh)


def test_head_placements():
    """K1 – K3's operands under a mesh: batch over data while it divides,
    heads over model only when H and KH both divide it (full tinyllava's
    20 / 5 heads on a model axis of 2 stay whole: an all-gather)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh(data=2, model=2)
    hp = attention_ops.head_placements
    assert hp(mesh, 8, 4, 4) == (Shard(0), Shard(2))
    assert hp(mesh, 8, 20, 5) == (Shard(0), Replicate())
    assert hp(mesh, 1, 4, 2) == (Replicate(), Shard(2))
    assert hp(_Mesh(data=1, model=1), 4, 20, 5) == (Replicate(),) * 2


# ---------------------------------------------------------------------------
# the context: the reference's tests/test_sharding_ctx.py cases
# ---------------------------------------------------------------------------

def test_ctx_noop_without_install():
    ctx.clear()
    x = torch.ones((4, 8, 16))
    assert ctx.constrain(x, "hidden") is x
    assert ctx.constrain_kv(x[:, 0]) is not None
    assert ctx.constrain_batch_tree({"a": x})["a"] is x
    assert not ctx.active() and ctx.dp_size() == 1


def test_ctx_divisibility_drop():
    ctx.install(("data",), axes=BIG)
    jctx.install(("data",), axes=BIG)
    try:
        # batch 1 does not divide 16: the constraint is dropped
        x = torch.ones((1, 8, 16))
        assert ctx.constrain(x, "hidden") is x
        assert ctx._fit_spec(("data", None, None), (1, 8, 16)) \
            == tuple(jctx._fit_spec(jax.sharding.PartitionSpec(
                "data", None, None), (1, 8, 16)))
        for shape in [(32, 8, 16), (16, 3, 5), (7, 16, 16)]:
            for spec in [("data", None, "model"), (("pod", "data"), None,
                                                   None)]:
                assert ctx._fit_spec(spec, shape) == tuple(jctx._fit_spec(
                    jax.sharding.PartitionSpec(*spec), shape))
        assert ctx.active() and ctx.dp_size() == jctx.dp_size() == 16
        # a plain tensor passes through every hook unchanged
        kv = torch.ones((16, 8, 64))
        assert ctx.constrain_kv(kv) is kv
        lat = kv[:, 0]
        assert ctx.constrain_latent(lat) is lat
        ctx.set_param_specs({"w": ("data", "model")})
        g = {"w": torch.ones((32, 32))}
        assert ctx.constrain_like_params(g)["w"] is g["w"]
    finally:
        ctx.clear()
        jctx.clear()
    assert not ctx.active()


def test_moe_groups_follow_the_mesh():
    """The MoE layer's group count: the reference's
    ``_pick_groups(t, max(dp_size, 16))`` with a mesh installed."""
    from repro.models.layers import moe as jmoe
    from repro_torch.models.layers import moe as tmoe
    for t in (64, 96, 100, 4096):
        assert tmoe._pick_groups(t) == jmoe._pick_groups(t, 16)
        assert tmoe._pick_groups(t, 32) == jmoe._pick_groups(t, 32)
    ctx.install(("data",), axes={"data": 32, "model": 2})
    try:
        x = torch.zeros((4, 16, 8))
        p = dict(router=torch.zeros((8, 4)), w_gate=torch.zeros((4, 8, 16)),
                 w_up=torch.zeros((4, 8, 16)), w_down=torch.zeros((4, 16, 8)))
        y, _ = tmoe.moe_forward(p, x, top_k=2)
        assert y.shape == x.shape  # 32 groups of 2 tokens
    finally:
        ctx.clear()


def test_dtensor_refused_by_every_kernel_wrapper():
    """A DTensor handed to any kernel wrapper (K1 – K12) raises TypeError:
    a kernel takes one rank's local tensors (``local_map``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import ops
    from repro_torch.wq.ops import wq_matmul
    from repro_torch.wq.packed import PackedLinear

    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (1,))

        def d(t):
            return DTensor.from_local(t, mesh, [Replicate()])

        q = d(torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16))
        pos = torch.arange(64, dtype=torch.int32)
        m = torch.zeros((1, 2, 64, 1))
        qf = d(torch.zeros((1, 1, 2, 64)))
        cache = torch.zeros((1, 16, 1, 64))
        kpos = torch.zeros((1, 16), dtype=torch.int32)
        one = torch.zeros((1,), dtype=torch.int32)
        table = torch.zeros((1, 1), dtype=torch.int32)
        sc = torch.zeros((1, 16, 1), dtype=torch.float16)
        calls = {
            "flash_forward": lambda: attention_ops.flash_forward(
                q, q, q, pos, pos),
            "flash_backward_dq": lambda: attention_ops.flash_backward_dq(
                q, q, q, q, m, m, m, pos, pos),
            "flash_backward_dkv": lambda: attention_ops.flash_backward_dkv(
                q, q, q, q, m, m, m, pos, pos),
            "decode": lambda: attention_ops.decode(qf, cache, cache, kpos,
                                                   one),
            "decode_q8": lambda: attention_ops.decode_q8(
                qf, cache, cache, sc, sc, kpos, one),
            "decode_paged": lambda: attention_ops.decode_paged(
                qf, cache, cache, kpos, table, one),
            "decode_paged_q8": lambda: attention_ops.decode_paged_q8(
                qf, cache, cache, sc, sc, kpos, table, one),
            "rdfsq_quantize": lambda: ops.rdfsq_quantize(
                d(torch.zeros((2, 64))), 2),
            "rdfsq_dequantize": lambda: ops.rdfsq_dequantize(
                d(torch.zeros((2, 16), dtype=torch.uint8)),
                torch.zeros((2, 2)), 2, 64),
            "nf_quantize": lambda: ops.nf_quantize(
                d(torch.zeros((128,))), 4),
            "nf_dequantize": lambda: ops.nf_dequantize(
                d(torch.zeros((2, 32), dtype=torch.uint8)),
                torch.zeros((2, 1)), {}, 4, 128, double_quant=False),
            "wq_matmul": lambda: wq_matmul(d(torch.zeros((2, 128))),
                                           PackedLinear(
                codes=torch.zeros((64, 16), dtype=torch.uint8),
                scales=torch.ones((1, 16)), mins=torch.zeros((1, 16)),
                perm=None, bits=4, group=128, d_in=128, d_out=16)),
            "flash (the model's entry)": lambda: attention_ops.flash(
                q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2),
                pos, pos, None),
        }
        for name, call in calls.items():
            with pytest.raises(TypeError, match="DTensor"):
                call()
    finally:
        dist.destroy_process_group()
