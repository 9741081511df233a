"""flax msgpack checkpoints in the PyTorch port, held against flax on the
CPU: the port's own codec (``utils/msgpack.py``) decodes what
``flax.serialization.msgpack_serialize`` writes, and writes the same
bytes; ``checkpoint_convert.flax_from_state_dict`` is the JAX package's
``convert_torch_state_dict``; ``.ckpt`` files cross between the packages
with the forward within the parity bar (sigmoid within 1e-4, fp32, exact
kNN)."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack as msgpack_py

from flax_forward import flax_probs
from pointstowood_tpu.model import Net as JNet
from pointstowood_tpu.utils import checkpoint as j_checkpoint
from pointstowood_tpu.utils.checkpoint_convert import convert_torch_state_dict
from pointstowood_tpu_torch.model import Net as TNet
from pointstowood_tpu_torch.predict.predicter import forward_probs
from pointstowood_tpu_torch.utils import checkpoint as t_checkpoint
from pointstowood_tpu_torch.utils import msgpack
from pointstowood_tpu_torch.utils.checkpoint_convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores: pin torch's
    intra-op threads (see tests/test_torch_net.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the parity path of tests/test_torch_net.py: fp32, exact kNN
KW = dict(channels=8, k=32, knn_method="exact", voxel_priority="last",
          stage_fractions=(1.0, 1.0, 1.0))


def _cloud(seed=3, n=512):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 0.6, size=(n, 3)).astype(np.float32)
    xyz -= xyz.mean(axis=0)
    refl = rng.normal(size=n).astype(np.float32)
    sf = np.float32(np.linalg.norm(xyz, axis=1).max())
    return xyz[None], refl[None], np.ones((1, n), bool), np.array([sf])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = np.asarray(got[name])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.fixture(scope="module")
def jax_variables():
    """The module's one JAX ``Net.init`` (C=8): its variables with every
    leaf moved off the values an init gives (BatchNorm statistics 0 and
    1), as numpy arrays."""
    inputs = _cloud()
    variables = jax.jit(functools.partial(
        JNet(**KW, dtype=jnp.float32).init, training=False))(
            jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(5)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)).astype(
            np.float32), variables)


@pytest.fixture(scope="module")
def jax_ckpt(jax_variables, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "model.ckpt")
    j_checkpoint.save_checkpoint(path, jax_variables)
    return path


def test_decoder_equals_msgpack_restore(jax_ckpt):
    with open(jax_ckpt, "rb") as f:
        data = f.read()
    _assert_same_tree(msgpack.unpackb(data),
                      flax.serialization.msgpack_restore(data))


def test_key_map_covers_every_leaf_of_an_init(jax_variables):
    """A port-written .ckpt is complete: the state_dict of a port Net at
    default flags maps onto every flax leaf of a JAX init, and onto no
    other."""
    tree = flax_from_state_dict(TNet(**KW).state_dict())
    want = {(name, np.shape(v)) for name, v in _leaves(jax_variables)}
    got = {(name, v.shape) for name, v in _leaves(tree)}
    assert len(want) == 224
    assert got == want


def test_flax_from_state_dict_is_convert_torch_state_dict(jax_variables):
    sd = state_dict_from_flax(jax_variables)
    _assert_same_tree(flax_from_state_dict(sd),
                      convert_torch_state_dict(sd))
    # and the inverse of state_dict_from_flax
    _assert_same_tree(flax_from_state_dict(sd), jax_variables)
    wrapped = {f"module.{k}": v for k, v in sd.items()}
    _assert_same_tree(flax_from_state_dict(wrapped), jax_variables)


def test_flax_from_state_dict_rejects_an_unmapped_entry():
    sd = TNet(**KW).state_dict()
    sd["extra.weight"] = torch.zeros(3)
    with pytest.raises(KeyError, match="extra.weight"):
        flax_from_state_dict(sd)


def test_encoder_bytes_equal_flax(jax_variables):
    """flax serializes a copy made by jax.tree_util, which sorts dict
    keys; the port's encoder sorts them too, so the bytes are equal (no
    fallback to equality after decoding was needed)."""
    sd = state_dict_from_flax(jax_variables)
    want = flax.serialization.msgpack_serialize(convert_torch_state_dict(sd))
    assert msgpack.packb(flax_from_state_dict(sd)) == want


@pytest.mark.parametrize("max_chunk", [64, 1000, 4096])
def test_chunked_leaves(monkeypatch, max_chunk):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", max_chunk)
    rng = np.random.default_rng(max_chunk)
    tree = {"params": {"big": rng.normal(size=(37, 41)).astype(np.float32),
                       "ints": np.arange(3000, dtype=np.int64),
                       "small": np.ones(3, np.float32)},
            "batch_stats": {"m": rng.normal(size=(9,)).astype(np.float64)}}
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    assert msgpack.packb(tree, max_chunk=max_chunk) == data
    _assert_same_tree(msgpack.unpackb(data), tree)


def test_bf16_chunked_leaf(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    leaf = jnp.asarray(np.linspace(-3, 3, 100), jnp.bfloat16)
    data = flax.serialization.msgpack_serialize({"w": leaf})
    got = msgpack.unpackb(data)["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), torch.from_numpy(
        np.asarray(leaf, np.float32)))
    assert msgpack.packb({"w": got}, max_chunk=64) == data


@pytest.mark.parametrize("scalar", [
    np.float32(2.5), np.float64(-1e300), np.int32(-7), np.int64(2**40),
    np.uint8(200), np.bool_(True), np.float16(0.1)])
def test_npscalar_ext(scalar):
    tree = {"s": scalar, "nested": {"t": scalar}}
    data = flax.serialization.msgpack_serialize(tree)
    assert msgpack.packb(tree) == data
    got = msgpack.unpackb(data)
    want = flax.serialization.msgpack_restore(data)
    for g, w in ((got["s"], want["s"]), (got["nested"]["t"],
                                         want["nested"]["t"])):
        assert type(g) is type(w) and g == w


def test_bf16_leaves_become_torch_bf16():
    values = np.array([[1.5, -2.0, 3.25e-3], [7e10, -0.0, 1e-20]])
    tree = {"w": jnp.asarray(values, jnp.bfloat16),
            "s": jnp.bfloat16(1.5)}
    data = flax.serialization.msgpack_serialize(tree)
    got = msgpack.unpackb(data)
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (2, 3)
    want = np.asarray(tree["w"], np.float32)
    assert torch.equal(got["w"].float(), torch.from_numpy(want))
    assert got["s"].dtype == torch.bfloat16 and float(got["s"]) == 1.5
    assert msgpack.packb({"w": got["w"]}) == \
        flax.serialization.msgpack_serialize({"w": tree["w"]})
    # a bf16 leaf maps into an fp32 state_dict
    assert torch.equal(state_dict_from_flax(
        {"params": {"conv1": {"kernel": got["w"].T, "bias": got["w"][0]}}}
    )["conv1.weight"][..., 0], torch.from_numpy(want))


def test_python_values_in_smallest_form():
    """Every msgpack form msgpack-python picks (keys already sorted, so
    the sorting encoder keeps their order)."""
    tree = {"arr": list(range(20)), "bin": b"\x00" * 300, "f": False,
            "floats": [0.0, -1.5, 1e308],
            "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**64 - 1,
                     -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
                     -2**63],
            "map": {f"{i:02d}": i for i in range(20)}, "none": None,
            "s": "x" * 31, "s300": "z" * 300, "s32": "y" * 32, "t": True,
            "u": "bark \u00e9"}
    want = msgpack_py.packb(tree, use_bin_type=True)
    assert msgpack.packb(tree) == want
    assert msgpack.unpackb(want) == msgpack_py.unpackb(want, raw=False)


@pytest.mark.parametrize("code", [0, 2, 4, 5, 127, -1])
def test_unknown_ext_code_raises(code):
    # {"x": fixext 2 of the code}
    data = b"\x81\xa1x\xd5" + code.to_bytes(1, "big", signed=True) + b"ab"
    with pytest.raises(ValueError, match=f"ext code {code}"):
        msgpack.unpackb(data)


def test_complex_ext_of_flax_raises():
    data = flax.serialization.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(ValueError, match="ext code 2"):
        msgpack.unpackb(data)


@pytest.mark.parametrize("data", [b"\xc1", b"\x82\xa1a", b"\x80\x00"])
def test_malformed_data_raises(data):
    with pytest.raises(ValueError):
        msgpack.unpackb(data)


def test_jax_ckpt_serves_in_the_port(jax_variables, jax_ckpt):
    """A JAX ``save_checkpoint`` file loads into the port (strict), whose
    forward matches flax's within 1e-4."""
    inputs = _cloud(seed=17)
    tnet = t_checkpoint.load_checkpoint(jax_ckpt, TNet(**KW)).eval()
    got = forward_probs(tnet, *[torch.from_numpy(np.array(a))
                                for a in inputs]).numpy()
    want = np.asarray(flax_probs(JNet(**KW, dtype=jnp.float32),
                                 jax_variables, *inputs))
    assert np.abs(got - want).max() < 1e-4


def test_port_ckpt_serves_in_jax(jax_variables, tmp_path):
    """A port ``save_checkpoint`` .ckpt loads in the JAX package's
    ``load_checkpoint``, whose forward matches the port's within 1e-4;
    a .pth of the same net stays a torch file."""
    tnet = TNet(**KW)
    tnet.load_state_dict(state_dict_from_flax(jax_variables))
    path = str(tmp_path / "port.ckpt")
    t_checkpoint.save_checkpoint(path, tnet)
    restored = j_checkpoint.load_checkpoint(path)
    _assert_same_tree(restored, jax_variables)
    inputs = _cloud(seed=17)
    want = forward_probs(tnet.eval(), *[torch.from_numpy(np.array(a))
                                        for a in inputs]).numpy()
    got = np.asarray(flax_probs(JNet(**KW, dtype=jnp.float32), restored,
                                *inputs))
    assert np.abs(got - want).max() < 1e-4
    pth = str(tmp_path / "port.pth")
    t_checkpoint.save_checkpoint(pth, tnet)
    assert "model_state_dict" in torch.load(pth, weights_only=True)
    back = t_checkpoint.load_checkpoint(path, TNet(**KW)).state_dict()
    for k, v in tnet.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k


def test_trainer_resumes_from_a_ckpt_and_names_epochs_by_it(tmp_path):
    """semantic_training loads an existing .ckpt model file (as the JAX
    trainer does) and writes its epoch checkpoints with the .ckpt suffix
    (2 tiles, 1 epoch, C=8)."""
    from pointstowood_tpu_torch.config import (ModelConfig, TilingConfig,
                                               TrainConfig)
    from pointstowood_tpu_torch.data.tiling import Tile
    from pointstowood_tpu_torch.train.trainer import semantic_training

    rng = np.random.default_rng(0)
    tiles = []
    for i in range(2):
        pts = rng.uniform(0, 1, (256, 5)).astype(np.float32)
        pts[:, 4] = rng.uniform(size=256) < 0.3
        tiles.append(Tile(points=pts, grid_size=4.0, cell_id=i))
    tnet = TNet(channels=8)
    with torch.no_grad():
        for p in tnet.parameters():
            p.add_(0.01)
    os.makedirs(tmp_path / "model")
    t_checkpoint.save_checkpoint(str(tmp_path / "model" / "m.ckpt"), tnet)
    logs = []
    state, _ = semantic_training(
        tiles, TrainConfig(num_epochs=1, batch_size=2),
        ModelConfig(channels=8, compute_dtype="float32"),
        TilingConfig(min_pts=64, max_pts=256), wdir=str(tmp_path),
        model_name="m.ckpt", checkpoints=[1], log_fn=logs.append,
        device="cpu")
    assert "Loading model" in logs
    assert (tmp_path / "checkpoints" / "epoch_1.ckpt").is_file()
    saved = j_checkpoint.load_checkpoint(str(tmp_path / "model" / "m.ckpt"))
    assert "params" in saved and "batch_stats" in saved


def test_port_needs_no_msgpack_laspy_or_sklearn():
    """The checkpoint, LAS and CLI modules load with msgpack, laspy and
    sklearn absent from sys.modules (the card's machine has none)."""
    code = (
        "import sys, json\n"
        "import pointstowood_tpu_torch.utils.checkpoint\n"
        "import pointstowood_tpu_torch.io\n"
        "import pointstowood_tpu_torch.cli.predict\n"
        "import pointstowood_tpu_torch.cli.train\n"
        "import pointstowood_tpu_torch.train.trainer\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    import json

    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for top in ("msgpack", "laspy", "sklearn", "flax", "jax", "pandas"):
        assert not [m for m in loaded
                    if m == top or m.startswith(top + ".")], top
