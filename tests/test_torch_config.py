"""The port's configs equal the reference's field for field."""
import pytest

pytest.importorskip("jax")

import dataclasses  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import default_split  # noqa: E402
from repro.core.quantizers import QuantConfig  # noqa: E402
from repro.core.split import SplitConfig  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.configs.base import \
    default_split as torch_default_split  # noqa: E402
from repro_torch.core.quantizers import \
    QuantConfig as TorchQuantConfig  # noqa: E402
from repro_torch.core.split import \
    SplitConfig as TorchSplitConfig  # noqa: E402


@pytest.mark.parametrize("reduced", [False, True])
def test_tinyllava_config_matches_reference(reduced):
    ref, port = get_config("tinyllava"), torch_get_config("tinyllava")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.block_pattern() == ref.block_pattern()
    assert port.segments() == ref.segments()
    assert port.client_server_segments() == ref.client_server_segments()


@pytest.mark.parametrize("cut", [-1, 0, 3, 16, 40])
def test_segments_follow_the_cut(cut):
    ref = dataclasses.replace(get_config("tinyllava"),
                              split=default_split(cut_layer=cut))
    port = dataclasses.replace(torch_get_config("tinyllava"),
                               split=torch_default_split(cut_layer=cut))
    assert port.segments() == ref.segments()
    assert port.client_server_segments() == ref.client_server_segments()
    assert port.split.resolve_cut(16) == ref.split.resolve_cut(16)


def test_split_and_quant_defaults_match():
    assert dataclasses.asdict(TorchSplitConfig()) == \
        dataclasses.asdict(SplitConfig())
    assert dataclasses.asdict(TorchQuantConfig()) == \
        dataclasses.asdict(QuantConfig())
    assert dataclasses.asdict(torch_default_split(2, "rdfsq", 4)) == \
        dataclasses.asdict(default_split(2, "rdfsq", 4))
    assert TorchQuantConfig(bits=3).levels == QuantConfig(bits=3).levels


def test_unported_config_raises():
    """Every config of the reference's is ported; an unknown name raises
    ``KeyError``."""
    with pytest.raises(KeyError, match="unknown arch 'rwkv7_7b'"):
        torch_get_config("rwkv7_7b")
    assert torch_get_config("rwkv6_7b").name == "rwkv6-7b"
