"""Data parallelism of the PyTorch port (``pointstowood_tpu_torch/parallel``)
on the CPU: two gloo processes against one process at the same global
batch, and against the JAX package on its simulated 2-device mesh.

One spawn of two processes (``_rank_main``, in the JAX-free
tests/test_torch_multihost.py; gloo over ``tcp://127.0.0.1``) computes
every sharded case; the single-process and JAX references are computed
here. The contract is the JAX package's
(``parallel/mesh.py:1-9``): W processes with global batch B compute what
one process computes with batch B.

* ``MaskedBatchNorm`` under a group equals the ungrouped module on the
  concatenated batch, in its output, the input's gradient, the summed
  parameter gradients and the running statistics, also where one
  process's rows are all padding (n = 0 there).
* ``random_sample`` under a group gives each process its rows of the one
  process's draw, bit for bit, over three draws of one generator.
* One train step (fp32, exact kNN, C = 8, a global batch of 4 tiles of
  256 points, the last all padding) on two processes, with the port's
  own random centres, equals the one-process step within 1e-5: loss,
  every gradient (relative L1 per tensor, and over the whole gradient),
  the running statistics, the parameters after AdamW and the counts.
  The reference is the data-parallel code in this process (a group of
  one). Measured: loss 9.9e-8 apart, gradients <= 7.6e-7 per tensor
  (2.3e-8 over the whole gradient), the running statistics and the
  parameters after the step within 2.1e-7.
  The biases and depthwise scales right in front of a batch-statistic
  BatchNorm have a true gradient of 0; theirs is rounding noise (<= 2e-8
  of the gradient's L1 mass, up to 12% apart between the two runs): it
  counts in the whole gradient's bar only, and those parameters, which
  Adam's first step moves by ~lr on any nonzero gradient, within 2.1 lr
  (tests/test_torch_train.py's bound). The match rests on what a data
  group changes (``model.layers.set_data_group``): float64 batch
  statistics (``_BatchStatsNorm``; with float32 sums, in an order that
  depends on the split, the same step lay 2.6% apart, relative L1 of a
  gradient tensor) and products a sample at a time (``dense``; here the
  BLAS keeps batched products within 7.6e-7, cuBLAS on the card does
  not). The split run lies 5.5% from the ungrouped step, whose float32
  statistics the JAX package's step holds within its noise; the split
  run is held to JAX's split step at the same bars (below).
* The same two-process step with ``tests/test_torch_train.py``'s centre
  rule against the JAX package's ``make_train_step`` on ``data_mesh(2)``,
  at tests/test_torch_attention.py's one-step bars: NOISE_FACTOR times
  the flax step's distance from itself on the reversed and nudged
  batches; counts within one point.
* ``run_inference`` on two processes (batch size 3, rounded to 2) equals
  one process (batch size 3): the JAX package's bar
  (``tests/test_parallel.py``: rtol 1e-4, atol 1e-5), labels equal.
* ``fuse_on_device`` with its entries split over the two processes gives
  the one-process codes bit for bit (the plain ``pair_select`` is
  exact), from the tight host-upload layout; that layout fuses as the
  FlatSink's does.
* ``shard_rows``, ``round_batch_size`` and ``maybe_init_distributed``'s
  no-op without launch variables.
* The last three modules against the JAX package: ``radius_masked``
  (tests/test_ops.py's case), the four masked segment ops (empty
  segments, masked rows, ids out of range), ``ReflectanceWeighting``
  (flax weights through ``state_dict_from_flax``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from chip_smoke import seeded_flax_variables
from pointstowood_tpu import config as j_config
from pointstowood_tpu.model import Net as JNet
from pointstowood_tpu.model import network as j_network
from pointstowood_tpu.parallel.mesh import (
    batch_sharding,
    data_mesh,
    replicated,
)
from pointstowood_tpu.train import trainer as j_trainer
from pointstowood_tpu_torch import config as t_config
from pointstowood_tpu_torch.model import Net as TNet
from pointstowood_tpu_torch.parallel import mesh as t_mesh
from pointstowood_tpu_torch.predict import device_fusion
from pointstowood_tpu_torch.predict import predicter as t_predicter
from pointstowood_tpu_torch.utils.checkpoint_convert import (
    state_dict_from_flax,
)
from test_torch_multihost import (
    _KW,
    LR,
    NET_KW,
    WORLD,
    _bn_inputs,
    _bn_run,
    _field,
    _free_port,
    _fuse_run,
    _fuse_scene,
    _infer_run,
    _rank_main,
    _sample_inputs,
    _sample_run,
    _train_inputs,
    _train_run,
)
from test_torch_attention import _nudged
from test_torch_attention import (
    test_attention_train_step_gradients_match_flax as _check_grads_vs_flax,
    test_attention_train_step_loss_matches_flax as _check_loss_vs_flax,
    test_attention_train_step_params_match_flax as _check_params_vs_flax,
    test_attention_train_step_running_stats_match_flax as
    _check_stats_vs_flax,
)
from test_torch_train import (
    _flax_update,
    _jax_rule,
    _np_tree,
    _recorder,
    _rel_l1,
)
from test_torch_train import (
    test_reflectance_gate_params_are_decayed as _check_gate_decay,
)

TOL = 1e-5  # the sharded step's bar against one process


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores (see
    test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The two processes' results (spawned once for the whole file)."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path_factory.mktemp("ranks"))
    mp.spawn(_rank_main, args=(_free_port(), out_dir), nprocs=WORLD,
             join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


# ------------------------------------------------------------------ tests


def test_shard_rows_and_batch_rounding():
    group = t_mesh.DataGroup(1, 2, None)
    a = np.arange(12).reshape(6, 2)
    (rows,) = t_mesh.shard_rows(group, a)
    np.testing.assert_array_equal(rows, a[3:])
    assert t_mesh.shard_rows(None, a)[0] is a
    with pytest.raises(ValueError):
        t_mesh.shard_rows(group, a[:5])
    four = t_mesh.DataGroup(0, 4, None)
    assert [t_mesh.round_batch_size(b, four) for b in (1, 4, 6, 9)] == \
        [4, 4, 4, 8]
    assert t_mesh.round_batch_size(3, None) == 3
    assert t_mesh.is_primary(None) and not t_mesh.is_primary(group)


def test_init_is_a_no_op_without_launch_variables(monkeypatch):
    for var in ("PTW_COORDINATOR_ADDRESS", "RANK", "WORLD_SIZE",
                "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert t_mesh.maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert t_mesh.data_group() is None


@pytest.mark.parametrize("device, backend, pinned", [
    ("cpu", "gloo", []), (None, "nccl", [1]), ("cuda", "nccl", [1])])
def test_init_follows_the_run_device(monkeypatch, device, backend, pinned):
    """The backend and the card pin follow the device the run computes on,
    not whether the host has CUDA: a CPU run on a CUDA host takes gloo and
    pins no card; a CUDA run takes NCCL on cuda:(rank mod cards)."""
    seen, pins = {}, []
    monkeypatch.setenv("PTW_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("PTW_NUM_PROCESSES", "2")
    monkeypatch.setenv("PTW_PROCESS_ID", "1")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(t_mesh, "pin_cuda_device", pins.append)
    monkeypatch.setattr(t_mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(t_mesh.dist, "init_process_group",
                        lambda b, **kw: seen.update(backend=b, **kw))
    monkeypatch.setattr(t_mesh.dist, "get_world_size", lambda: 2)
    assert t_mesh.maybe_init_distributed(device=device) is True
    assert seen == {"backend": backend, "init_method": "tcp://127.0.0.1:1",
                    "rank": 1, "world_size": 2}
    assert pins == pinned


@pytest.mark.parametrize("all_padding_rank", [False, True])
def test_masked_batch_norm_over_a_group(sharded, all_padding_rank):
    x, mask, ct, state = _bn_inputs(all_padding_rank)
    ref = _bn_run(x, mask, ct, state)
    key = f"bn{int(all_padding_rank)}"
    for k in ("y", "x_grad"):
        got = torch.cat([r[key][k] for r in sharded])
        torch.testing.assert_close(got, ref[k], rtol=TOL, atol=TOL, msg=k)
    for k in ("weight_grad", "bias_grad", "running_mean", "running_var"):
        for r in sharded:
            torch.testing.assert_close(r[key][k], ref[k], rtol=TOL,
                                       atol=TOL, msg=k)


def test_random_sample_over_a_group_is_the_one_process_draw(sharded):
    ref = _sample_run(_sample_inputs())
    for draw, (idx, valid) in enumerate(ref):
        got_idx = torch.cat([r["sample"][draw][0] for r in sharded])
        got_valid = torch.cat([r["sample"][draw][1] for r in sharded])
        assert torch.equal(got_idx, idx) and torch.equal(got_valid, valid)


@pytest.fixture(scope="module")
def one_process():
    """The step in this process over the whole batch, as a data group of
    one (no collectives)."""
    return _train_run(_train_inputs(), group=t_mesh.DataGroup(0, 1, None))


def test_sharded_step_equals_one_process(sharded, one_process):
    """Loss, counts, every gradient, every parameter and running statistic
    after the step, on both processes, within 1e-5 of one process."""
    ref = one_process
    assert ref["finite"]
    for r in sharded:
        got = r["train"]
        assert got["finite"]
        assert abs(got["loss"] - ref["loss"]) <= TOL * abs(ref["loss"])
        torch.testing.assert_close(got["counts"], ref["counts"], rtol=0,
                                   atol=0)
        mass = sum(float(g.abs().sum()) for g in ref["grads"].values())
        err = 0.0
        for k, g in ref["grads"].items():
            # per tensor, over the tensors that carry >= 1e-6 of the
            # gradient's L1 mass: the others (biases and depthwise scales
            # right in front of a batch-statistic BatchNorm, whose true
            # gradient is 0) carry rounding noise, <= 1e-10 of the mass,
            # and count in the whole gradient's bar below
            if float(g.abs().sum()) >= 1e-6 * mass:
                assert _rel_l1(got["grads"][k], g) <= TOL, k
            err += float((got["grads"][k] - g).abs().sum())
        assert err <= TOL * mass
        for k, v in ref["state"].items():
            g = ref["grads"].get(k)
            if g is not None and float(g.abs().sum()) < 1e-6 * mass:
                # a rounding-noise gradient: Adam's first step moves the
                # parameter by up to ~lr on a noise-level gradient
                assert float((got["state"][k] - v).abs().max()) <= 2.1 * LR
                continue
            torch.testing.assert_close(got["state"][k], v, rtol=TOL,
                                       atol=TOL, msg=k)
    # every process holds the same parameters and statistics
    for k, v in sharded[0]["train"]["state"].items():
        assert torch.equal(v, sharded[1]["train"]["state"][k]), k


@pytest.fixture(scope="module")
def jax_mesh_step():
    """The JAX package's train step on its 2-device data mesh over the
    same global batch, with the centre rule of tests/test_torch_train.py,
    and over three copies that change it only at the rounding level (its
    noise floor, as tests/test_torch_attention.py draws it): the batch
    reversed, and twice its coordinates and reflectances moved by -1, 0
    or +1 ulp at random."""
    inputs = _train_inputs()
    rng = np.random.default_rng(17)
    others = [[np.ascontiguousarray(a[::-1]) for a in inputs]] + [
        [_nudged(a, rng) if i in (0, 1) else a for i, a in enumerate(inputs)]
        for _ in range(2)]
    tnet = TNet(**NET_KW)
    variables = seeded_flax_variables(tnet, 7)
    jcfg = j_config.TrainConfig(learning_rate=LR)
    mesh = data_mesh(WORLD)
    repl, shard = replicated(mesh), batch_sharding(mesh)
    params = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), repl)
    stats = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), repl)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_network, "random_sample", _jax_rule)
        rec = optax.chain(_recorder())
        state0 = jax.device_put(jax.jit(rec.init)(params), repl)
        step = j_trainer.make_train_step(JNet(**NET_KW, dtype=jnp.float32),
                                         rec, jcfg)
        out, *selfs = [
            step(params, stats, state0,
                 *(jax.device_put(jnp.asarray(a), shard) for a in batch),
                 jnp.float32(LR), jax.random.PRNGKey(0))
            for batch in [inputs] + others]
    assert bool(out[5]) and all(bool(o[5]) for o in selfs)
    new_params = _flax_update(jcfg, _np_tree(out[2][0].grads),
                              _np_tree(params), LR)

    def sd(p, batch_stats=None):
        tree = {"params": _np_tree(p)}
        if batch_stats is not None:
            tree["batch_stats"] = _np_tree(batch_stats)
        return state_dict_from_flax(tree)

    return {"out": out, "selfs": selfs, "sd": sd, "new_params": new_params,
            "params": params}


def test_sharded_step_matches_jax_data_mesh(sharded, jax_mesh_step):
    """The two processes' step (the centre rule of test_torch_train.py)
    against JAX's step on data_mesh(2), at tests/test_torch_attention.py's
    one-step bars: loss, gradients, running statistics and parameters
    within NOISE_FACTOR times the flax step's distance from itself on the
    reversed and nudged batches (one such draw is not enough for the
    plain Net at N = 256, as that file measured), the head within rtol
    1e-4, counts within one point of JAX's (a prediction at the 0.5
    threshold); the gate's parameters decayed as optax decays them."""
    m = jax_mesh_step
    out, selfs, sd = m["out"], m["selfs"], m["sd"]
    params = m["params"]
    for r in sharded:
        got = r["train_rule"]
        case = {
            "variant": "plain",
            "loss": (got["loss"], float(out[3]),
                     [float(o[3]) for o in selfs]),
            "finite": got["finite"],
            "grads": (got["grads"], sd(out[2][0].grads),
                      [sd(o[2][0].grads) for o in selfs]),
            "stats": (got["state"], sd(params, out[1]),
                      [sd(params, o[1]) for o in selfs]),
            "params": (got["state"], sd(m["new_params"])),
            "self_grads": [sd(o[2][0].grads) for o in selfs],
            "before": got["before"],
        }
        _check_loss_vs_flax(case)
        _check_grads_vs_flax(case)
        _check_stats_vs_flax(case)
        _check_params_vs_flax(case)
        _check_gate_decay(case)
        counts = got["counts"].numpy()
        assert counts.sum() == np.asarray(out[4]).sum()
        assert np.abs(counts - np.asarray(out[4])).max() <= 1


def test_sharded_inference_equals_one_process(sharded):
    ref = _infer_run()
    for r in sharded:
        got = r["infer"]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got[:, 3], ref[:, 3])


def test_split_pair_fusion_equals_one_process(sharded):
    """Codes bit for bit; each process selects over its own share of the
    entries, and the shares add up to the plan's."""
    ref = _fuse_run()
    assert ref["n_entries"] >= 2 * WORLD
    for r in sharded:
        np.testing.assert_array_equal(r["fuse"]["fused"], ref["fused"])
    shares = [r["fuse"]["entries"] for r in sharded]
    assert all(shares) and sum(shares) == ref["n_entries"] == ref["entries"]


def test_tight_layout_fuses_like_the_sink():
    """The host-upload layout (tile points, the gathered probabilities)
    against the FlatSink's (positions + shifts written by the model
    phase): the same fusion up to ties that the sink's one rounding of
    the coordinates can break."""
    tiles, query_xyz, plan, resident = _fuse_scene()
    batcher = t_predicter.tile_batcher(
        tiles, t_config.PredictConfig(batch_size=4),
        t_config.TilingConfig(**_KW))
    sink = device_fusion.sink_for(tiles, batcher, "cpu")
    for _, batch, _ in batcher:
        xyz = batch.pos + batch.shift[:, None, :]
        sink.write(torch.from_numpy(batch.pos), batch.shift,
                   torch.from_numpy(_field(xyz.reshape(-1, 3)).reshape(
                       xyz.shape[:2]).astype(np.float32)))
    sink_plan = device_fusion.plan_fusion(tiles, query_xyz, _KW["min_pts"],
                                          sink.layout)
    a = device_fusion.fuse_on_device(plan, resident, query_xyz, 0.5, 1.0,
                                     device="cpu")
    b = device_fusion.fuse_on_device(sink_plan, sink.arrays(), query_xyz,
                                     0.5, 1.0, device="cpu")
    assert (a[:, 0] == b[:, 0]).mean() >= 0.999
    assert np.abs(a[:, 1] - b[:, 1]).mean() < 1e-3
    assert device_fusion.layout_tight(tiles, batcher.tile_order()) \
        .flat_len == sum(len(t) for t in tiles)


# ------------------------------------- the last three modules of the port


def test_radius_masked_matches_jax():
    """tests/test_ops.py's radius case (300 sources in a 10 m cube, the
    first 50 as queries, r = 1, k = 16) against JAX's exact route: the
    same neighbour sets and distances, beyond-radius slots invalid; the
    fast route's plain version gives the same."""
    from pointstowood_tpu.ops.knn import radius_masked as j_radius
    from pointstowood_tpu_torch.ops import radius_masked

    rng = np.random.default_rng(141190)
    src = rng.uniform(0, 10, size=(300, 3)).astype(np.float32)
    q = src[:50]
    smask = np.ones(300, bool)
    smask[250:] = False
    qmask = np.ones(50, bool)
    qmask[-3:] = False
    j_idx, j_d2, j_valid = map(np.asarray, j_radius(
        jnp.asarray(q), jnp.asarray(src), radius=1.0, k=16, chunk_size=64,
        method="exact", query_mask=jnp.asarray(qmask),
        source_mask=jnp.asarray(smask)))
    for method in ("exact", "fast"):
        idx, d2, valid = (t[0].numpy() for t in radius_masked(
            torch.from_numpy(q)[None], torch.from_numpy(src)[None], 1.0, 16,
            query_mask=torch.from_numpy(qmask)[None],
            source_mask=torch.from_numpy(smask)[None], method=method))
        np.testing.assert_array_equal(valid, j_valid)
        for row in range(50):
            assert set(idx[row][valid[row]]) == set(j_idx[row][j_valid[row]])
        # d2 within 1e-6 of ||q||^2 + ||s||^2 (ROADMAP.md: the expansion
        # JAX's exact path ranks by rounds at that scale)
        scale = float((q ** 2).sum(1).max() + (src ** 2).sum(1).max())
        np.testing.assert_allclose(np.sort(d2, -1), np.sort(j_d2, -1),
                                   rtol=0, atol=1e-6 * scale)
        assert (idx[~valid] == 0).all() and np.isinf(d2[~valid]).all()
        assert (d2[valid] <= 1.0).all() and valid[:, 0][:47].all()


@pytest.mark.parametrize("op", ["segment_max", "segment_min",
                                "segment_sum", "segment_mean"])
def test_segment_ops_match_jax(op):
    """tests/test_ops.py's segments (a masked row, an empty segment), plus
    ids outside [0, num_segments), which both drop, and rows of two
    channels' axes."""
    from pointstowood_tpu.ops import segment as j_segment
    from pointstowood_tpu_torch.ops import segment as t_segment

    rng = np.random.default_rng(141190)
    data = rng.normal(size=(10, 3)).astype(np.float32)
    cases = [
        (data, np.array([0, 0, 1, 1, 1, 2, 2, 3, 3, 3]),
         np.array([True] * 9 + [False]), 5),
        (data, np.array([0, -1, 1, 1, 7, 2, 2, 3, 5, 3]), None, 5),
        (data.reshape(5, 2, 3), np.array([0, 1, 1, 3, 0]),
         np.array([True, False, True, True, True]), 4),
    ]
    for x, ids, mask, n in cases:
        ref = np.asarray(getattr(j_segment, op)(
            jnp.asarray(x), jnp.asarray(ids), n,
            mask=None if mask is None else jnp.asarray(mask)))
        got = getattr(t_segment, op)(
            torch.from_numpy(x), torch.from_numpy(ids), n,
            mask=None if mask is None else torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    empty = getattr(t_segment, op)(torch.from_numpy(data),
                                   torch.zeros(10, dtype=torch.long), 3)
    assert (empty[1:] == 0).all()


def test_reflectance_weighting_matches_flax():
    """The flax module's weights carried across by state_dict_from_flax
    (its fc1, fc2 and fc3, under the reflectance gate's keys): outputs
    within 1e-6, with a mask (padding excluded from the pool) and
    without."""
    from pointstowood_tpu.model.layers import (
        ReflectanceWeighting as JWeighting,
    )
    from pointstowood_tpu_torch.model.layers import ReflectanceWeighting

    rng = np.random.default_rng(3)
    refl = rng.normal(size=(2, 16)).astype(np.float32)
    mask = np.arange(16)[None, :] < np.array([[16], [9]])
    refl[1, 9:] = 1e3
    jmod = JWeighting(hidden_dim=8)
    params = jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(refl),
                                mask=jnp.asarray(mask))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(size=a.shape) * 0.1)
        .astype(np.float32), params)
    prefix = "sa1_module.reflectanceyesno."
    sd = {k[len(prefix):]: v for k, v in state_dict_from_flax(
        {"params": {"sa1_module": {"reflectanceyesno": params}}}).items()
        if k.startswith(prefix)}
    tmod = ReflectanceWeighting(hidden_dim=8)
    tmod.load_state_dict(sd, strict=True)
    for m in (mask, None):
        ref = np.asarray(jax.jit(lambda r, mm: jmod.apply(
            {"params": params}, r, mask=mm))(
                jnp.asarray(refl), None if m is None else jnp.asarray(m)))
        got = tmod(torch.from_numpy(refl),
                   None if m is None else torch.from_numpy(m)).detach()
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
        assert (got >= 0).all() and torch.equal(got, got[:, :1].expand(-1,
                                                                       16))
