"""Weight bridge of the PyTorch port (accflow_tpu_torch/convert.py) against
the JAX param trees: JAX tree -> port module -> JAX tree is exact, and the
JAX package's own converter reads the port's state_dict back to the same
tree (the port follows the reference state_dict names)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from accflow_tpu.convert.store import _flatten, load_params
from accflow_tpu.convert.torch_weights import convert_state_dict
from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
from accflow_tpu.models.accflow import init_accflow as j_init_accflow
from accflow_tpu.models import encoders as j_enc
from accflow_tpu.models.raft import RAFTConfig as JRAFTConfig
from accflow_tpu.models.raft import init_raft as j_init_raft
from accflow_tpu_torch.convert import load_jax_params, load_npz_tree, to_jax_params
from accflow_tpu_torch.models import AccFlowConfig, RAFTConfig, init_accflow, init_raft
from accflow_tpu_torch.models.encoders import BasicEncoder, SmallEncoder


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after.
    The tests run in several worker processes on one machine; with torch's
    default of a thread per core in each, they oversubscribe its cores
    (tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIXTURE_ACC = str(Path(__file__).parent / "fixtures" / "drift_small_acc.npz")  # trained, hidden 64
FIXTURE_OFE = str(Path(__file__).parent / "fixtures" / "drift_small_ofe.npz")  # trained RAFT-small


def _case(name):
    if name == "raft":
        return j_init_raft(jax.random.PRNGKey(0), JRAFTConfig()), init_raft(
            RAFTConfig(), device="cpu")
    if name == "raft_small":
        return j_init_raft(jax.random.PRNGKey(0), JRAFTConfig(small=True)), init_raft(
            RAFTConfig(small=True), device="cpu")
    if name == "raft_small_fixture":  # stored as float16
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), load_params(FIXTURE_OFE))
        return tree, init_raft(RAFTConfig(small=True), device="cpu")
    if name == "accflow":
        return j_init_accflow(jax.random.PRNGKey(1), JAccFlowConfig()), init_accflow(
            AccFlowConfig(), device="cpu")
    if name in ("basic_encoder_group", "small_encoder_group"):
        # Group norms' scale and bias drawn away from their ones and zeros.
        small = name.startswith("small")
        init = j_enc.init_small_encoder if small else j_enc.init_basic_encoder
        tree = init(jax.random.PRNGKey(2), *(() if small else (3,)), 48, "group")
        rng = np.random.default_rng(2)
        tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        return tree, (SmallEncoder if small else BasicEncoder)(48, "group")
    return load_params(FIXTURE_ACC), init_accflow(AccFlowConfig(hidden=64), device="cpu")


def _assert_same_tree(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


@pytest.mark.parametrize("name", ["raft", "raft_small", "raft_small_fixture", "accflow",
                                  "accflow_fixture", "basic_encoder_group",
                                  "small_encoder_group"])
def test_round_trip_exact(name):
    tree, module = _case(name)
    load_jax_params(module, tree)
    _assert_same_tree(to_jax_params(module), tree)


@pytest.mark.parametrize("name", ["raft", "raft_small", "accflow"])
def test_jax_converter_reads_port_state_dict(name):
    tree, module = _case(name)
    load_jax_params(module, tree)
    _assert_same_tree(convert_state_dict(tree, module.state_dict()), tree)


@pytest.mark.parametrize("path", [FIXTURE_ACC, FIXTURE_OFE])
def test_npz_loader_matches_store(path):
    _assert_same_tree(load_npz_tree(path), load_params(path))


def test_float16_fixture_loads_as_float32():
    """The fixtures are stored as float16; load_jax_params widens every
    leaf exactly."""
    tree = load_npz_tree(FIXTURE_OFE)
    assert tree["fnet"]["conv1"]["w"].dtype == np.float16
    module = load_jax_params(init_raft(RAFTConfig(small=True), device="cpu"), tree)
    w = module.fnet.conv1.weight
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(w.detach().numpy(),
                                  tree["fnet"]["conv1"]["w"].astype(np.float32).transpose(3, 2, 0, 1))


def test_load_rejects_mismatched_tree():
    tree, module = _case("raft")
    del tree["update_block"]["flow_head"]["conv2"]["b"]
    with pytest.raises(KeyError):
        load_jax_params(module, tree)
    tree, module = _case("raft")
    tree["extra"] = {"w": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(ValueError):
        load_jax_params(module, tree)
